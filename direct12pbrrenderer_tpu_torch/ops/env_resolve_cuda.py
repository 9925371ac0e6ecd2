"""Env-cache tap resolve — counterpart of `ops/envcache.py::_kernel` over
`_resolve_env_group` (kernel F), the unfused deferred pass's env taps.

`env_resolve` launches the hand-written CUDA kernel `csrc/env_resolve.cu` for
CUDA tensors; for CPU tensors it runs `env_resolve_reference`, the plain
PyTorch version. There is no fallback between the two: a CUDA input either
launches the kernel or raises. `resolve_env_group` is the plain body of one
group's tap, shared with kernel D's plain version (`ops/shade_fused.py`), as
the CUDA body `csrc/env_resolve.cuh` is shared by kernels F and D.
"""

from __future__ import annotations

import torch

from ..kernels.launch import Entry
from .resolve_shade_cuda import staged_rows

REC_I32 = 8   # staged rows per page record: the 16 bf16 values packed in pairs
_LAUNCH = Entry("env_resolve", "env_resolve_launch", "pppipppiiip")


def env_resolve(off, cnts, staged, rec, fx, fy):
    """Resolve G groups of clamp-quad taps against the staged pages.

    off/cnts (tiles, G) int32 group start page and page count in the
    compact staged block; staged (tiles, B*8, 128) int32 (page p's value pair
    k at row p*8+k); rec (tiles, G, blocks, 128) int32 records (seg << 7 |
    lane); fx/fy (tiles, G, blocks, 128) f32 bilinear fracs. -> (tiles, G, 4,
    blocks, 128) f32 rgba."""
    if rec.device.type == "cpu":
        return env_resolve_reference(off, cnts, staged, rec, fx, fy)
    if rec.device.type != "cuda":
        raise ValueError(f"env_resolve: unsupported device {rec.device}")
    if rec.dim() != 4 or rec.shape[-1] != 128:
        raise ValueError(f"rec must be (tiles, G, blocks, 128), got {tuple(rec.shape)}")
    tiles, n_groups, blocks, _ = rec.shape
    shapes = {"off": (off, (tiles, n_groups), torch.int32),
              "cnts": (cnts, (tiles, n_groups), torch.int32),
              "rec": (rec, tuple(rec.shape), torch.int32),
              "fx": (fx, tuple(rec.shape), torch.float32),
              "fy": (fy, tuple(rec.shape), torch.float32)}
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != rec.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {rec.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if (staged.dtype != torch.int32 or staged.dim() != 3 or staged.shape[0] != tiles
            or staged.shape[1] % REC_I32 or staged.shape[2] != 128
            or staged.device != rec.device):
        raise ValueError(f"staged must be (tiles, B*{REC_I32}, 128) int32 on {rec.device}, "
                         f"got {tuple(staged.shape)} {staged.dtype} on {staged.device}")
    c = [x.contiguous() for x in (off, cnts, staged, rec, fx, fy)]
    dev = rec.device
    out = torch.empty((tiles, n_groups, 4, blocks, 128), dtype=torch.float32, device=dev)
    _LAUNCH(dev, c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(), staged.shape[1] // REC_I32,
            c[3].data_ptr(), c[4].data_ptr(), c[5].data_ptr(), tiles, n_groups, blocks,
            out.data_ptr())
    return out


# ------------------------------------------------------- plain version ----
def resolve_env_group(off, cnts, staged, rec, fx, fy, gi):
    """Group gi's clamp-quad tap: bf16 pairs unpacked (low half << 16, high
    half & ~0xFFFF, bit cast), bilinear blend -> 4 x (tiles, blocks, 128)."""
    packed = staged_rows(off, cnts, staged, rec, gi, REC_I32)

    def val(v):
        p = packed[v >> 1]
        return ((p & ~0xFFFF) if v & 1 else (p << 16)).view(torch.float32)

    f_x, f_y = fx[:, gi], fy[:, gi]
    w00 = (1 - f_x) * (1 - f_y)
    w01 = f_x * (1 - f_y)
    w10 = (1 - f_x) * f_y
    w11 = f_x * f_y
    return [val(c) * w00 + val(4 + c) * w01 + val(8 + c) * w10 + val(12 + c) * w11
            for c in range(4)]


def env_resolve_reference(off, cnts, staged, rec, fx, fy):
    """Plain PyTorch version of kernel F: every group's tap through
    `resolve_env_group` -> (tiles, G, 4, blocks, 128) f32."""
    return torch.stack([torch.stack(resolve_env_group(off, cnts, staged, rec, fx, fy, g), 1)
                        for g in range(rec.shape[1])], 1)
