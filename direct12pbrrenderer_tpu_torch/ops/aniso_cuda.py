"""The anisotropic sampler at the frame's active (pixel, slot) pairs: the
footprint and four trilinear taps of `gbuffer.sample_atlas_anisotropic` in
one pass.

`aniso_sample` launches the hand-written CUDA kernel `csrc/aniso_sample.cu`
for CUDA tensors; for CPU tensors it runs `aniso_sample_reference`, the
plain PyTorch version of the same function. There is no fallback between
the two: a CUDA input either launches the kernel or raises. No TPU kernel
is replaced: the JAX package's sampler is XLA glue.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.launch import Entry
from ..utils import trace

_LAUNCH = Entry("aniso_sample", "aniso_sample_launch", "ppipppippppppppiip")


def aniso_sample(atlas, uv, mask, use, tex):
    """Samples (H, W, 5, 4) f32 of the anisotropic filter, sRGB-linearized
    where flagged, at the covered pixels' used slots; 0 elsewhere.

    atlas: `gbuffer.AtlasDevice`; uv (H, W, 2) f32 from the masked
    interpolants (the quad differences are taken from it, so H and W are
    even); mask (H, W) bool coverage; use (H, W, 5) bool the slots the
    material samples; tex (H, W, 5) int64 texture ids. Any strides. Traced,
    the call is the spans `gbuffer.aniso_footprint` (on the card the checks
    before the launch; the footprint runs inside the taps' kernel) and
    `gbuffer.aniso_taps`."""
    if uv.device.type == "cpu":
        return aniso_sample_reference(atlas, uv, mask, use, tex)
    if uv.device.type != "cuda":
        raise ValueError(f"aniso_sample: unsupported device {uv.device}")
    with trace.span("gbuffer.aniso_footprint"):
        h, w = _check(atlas, uv, mask, use, tex)
        data, page_base, base_size, n_mips, srgb = (x.contiguous() for x in atlas)
        dev = uv.device
        out = torch.empty((h, w, 5, 4), dtype=torch.float32, device=dev)
    with trace.span("gbuffer.aniso_taps"):
        _LAUNCH(dev, data.data_ptr(), page_base.data_ptr(), page_base.shape[1],
                base_size.data_ptr(), n_mips.data_ptr(), srgb.data_ptr(), n_mips.shape[0],
                uv.data_ptr(), _strides(uv), mask.data_ptr(), _strides(mask), use.data_ptr(),
                _strides(use), tex.data_ptr(), _strides(tex), h, w, out.data_ptr())
    return out


def _check(atlas, uv, mask, use, tex) -> tuple[int, int]:
    if uv.dim() != 3 or uv.shape[2] != 2 or uv.shape[0] % 2 or uv.shape[1] % 2:
        raise ValueError(f"uv must be (H, W, 2) with H and W even, got {tuple(uv.shape)}")
    h, w = uv.shape[:2]
    fields = {"uv": (uv, (h, w, 2), torch.float32), "mask": (mask, (h, w), torch.bool),
              "use": (use, (h, w, 5), torch.bool), "tex": (tex, (h, w, 5), torch.int64)}
    tables = {"data": (atlas.data, (atlas.data.shape[0], 4), torch.int32),
              "page_base": (atlas.page_base, tuple(atlas.page_base.shape), torch.int32),
              "base_size": (atlas.base_size, (atlas.n_mips.shape[0], 2), torch.int32),
              "n_mips": (atlas.n_mips, (atlas.n_mips.shape[0],), torch.int32),
              "srgb": (atlas.srgb, (atlas.n_mips.shape[0],), torch.bool)}
    for name, (x, shape, dtype) in {**fields, **tables}.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != uv.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {uv.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if atlas.page_base.dim() != 2 or atlas.page_base.shape[0] != atlas.n_mips.shape[0]:
        raise ValueError(f"page_base must be (T, MAX_MIPS), got {tuple(atlas.page_base.shape)}")
    return h, w


def _strides(x):
    return (ctypes.c_longlong * x.dim())(*x.stride())


def aniso_sample_reference(atlas, uv, mask, use, tex):
    """Plain PyTorch version of the kernel: the quad derivatives and texture
    sizes as `gbuffer.tap_lod` takes them, `gbuffer.sample_atlas_anisotropic`
    (which records the two spans), then 0 at the inactive pairs."""
    from . import gbuffer

    ddx, ddy = gbuffer._quad_derivatives(uv)
    size5 = atlas.base_size[tex].float()
    samples = gbuffer.sample_atlas_anisotropic(atlas, tex, uv, ddx, ddy, size5, mask)
    return torch.where((use & mask[..., None])[..., None], samples, 0.0)
