"""Planar texture-cache resolve — counterpart of `ops/texcache.py::_kernel`,
the kernel of `sample_atlas_tiled` (kernel E).

`atlas_resolve` launches the hand-written CUDA kernel `csrc/atlas_resolve.cu`
for CUDA tensors; for CPU tensors it runs `atlas_resolve_reference`, the
plain PyTorch version of the same function. There is no fallback between
the two: a CUDA input either launches the kernel or raises. Kernel C's
resolve without the shade: both share one tap body (`csrc/tex_resolve.cuh`,
plain `resolve_shade_cuda.resolve_slot`).
"""

from __future__ import annotations

import ctypes

import torch

from .resolve_shade_cuda import check_taps, resolve_slot

_KERNEL = "atlas_resolve"


def atlas_resolve(off, cnts, staged, rec, fx, fy, tl, sel=None, *, trilinear: bool):
    """Resolve the 5 material slots' taps against the staged pages.

    off (tiles, G) int32 group start pages in the staged block; cnts (tiles,
    G[+1]) int32 page counts (with the cascade, column G is the tile's
    any-cascade flag); staged (tiles, B*4, 128) int32; rec/fx/fy (tiles, G,
    blocks, 128); tl (tiles, 5, blocks, 128) trilinear fracs; sel (tiles, 5,
    blocks, 128) int32 cascade mask or None. G = 10 trilinear, 5 bilinear,
    + 5 with the cascade. -> (tiles, 5, 4, blocks, 128) f32 storage-space
    rgba (no sRGB)."""
    if rec.device.type == "cpu":
        return atlas_resolve_reference(off, cnts, staged, rec, fx, fy, tl, sel,
                                       trilinear=trilinear)
    if rec.device.type != "cuda":
        raise ValueError(f"atlas_resolve: unsupported device {rec.device}")
    check_taps(off, cnts, staged, rec, fx, fy, tl, sel, trilinear)
    tiles, n_groups, blocks, _ = rec.shape
    off, cnts, staged, rec, fx, fy, tl = (x.contiguous()
                                          for x in (off, cnts, staged, rec, fx, fy, tl))
    sel = sel.contiguous() if sel is not None else None
    dev = rec.device
    out = torch.empty((tiles, 5, 4, blocks, 128), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.atlas_resolve_launch(
            off.data_ptr(), cnts.data_ptr(), cnts.shape[1], staged.data_ptr(),
            staged.shape[1] // 4, rec.data_ptr(), fx.data_ptr(), fy.data_ptr(), tl.data_ptr(),
            sel.data_ptr() if sel is not None else None, tiles, n_groups, blocks,
            int(trilinear), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"atlas_resolve kernel launch failed: CUDA error {err}")
        atlas_resolve.launches += 1
    return out


atlas_resolve.launches = 0  # kernel launches in this process (reset by callers)


def _library() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_KERNEL)
    fn = lib.atlas_resolve_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, p, p, p, p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def atlas_resolve_reference(off, cnts, staged, rec, fx, fy, tl, sel=None, *,
                            trilinear: bool):
    """Plain PyTorch version of the kernel: kernel C's plain tap body per
    slot, over whole (tiles, blocks, 128) planes."""
    return torch.stack([torch.stack(resolve_slot(off, cnts, staged, rec, fx, fy, tl, sel, s,
                                                 trilinear), 1) for s in range(5)], 1)
