"""The per-pixel planes that kernels C and D read in place.

A plane is a (tiles, G, blocks, 128) tensor of 4-byte words. The kernels
(`csrc/tap_planes.cuh`) read it in place through its strides, thread x of a
block reading lane x of one row, and take two layouts:

* lane-contiguous (lane stride 1): a warp's read of one group is one
  128-byte line, e.g. a contiguous plane or the `torch.cat` of whole planes;
* group-innermost (group stride 1, lane stride S with G <= S <= 32): a
  pixel's words lie within 128 bytes, e.g. the trilinear fracs that the
  texture plan stacks with the group last, or the channels 2..18 of the
  raster rows (tiles, p, 24).

`plane_strides` gives the strides the kernels take and raises on any other
layout (where a warp's reads would scatter over many lines), so a wrapper
never copies a plane.
"""

from __future__ import annotations

import ctypes

import torch

MAX_LANE_STRIDE = 32   # a group-innermost pixel's words within one 128-byte line


def plane_strides(name: str, x: torch.Tensor) -> tuple[int, int, int, int]:
    """(tile, group, row, lane) element strides of the (tiles, G, blocks,
    128) plane `x` of 4-byte words, lane-contiguous or group-innermost;
    ValueError on another layout or element size."""
    if x.dim() != 4 or x.shape[-1] != 128 or x.element_size() != 4:
        raise ValueError(f"{name} must be a (tiles, G, blocks, 128) plane of 4-byte words, "
                         f"got {tuple(x.shape)} {x.dtype}")
    st, sg, sr, sx = x.stride()
    groups = x.shape[1]
    if sx == 1 or (sg == 1 and groups <= sx <= MAX_LANE_STRIDE):
        return st, sg, sr, sx
    raise ValueError(f"{name}: the kernel reads a plane lane-contiguous (lane stride 1) or "
                     f"group-innermost (group stride 1, lane stride {groups}.."
                     f"{MAX_LANE_STRIDE}); got strides {x.stride()} for shape "
                     f"{tuple(x.shape)}")


def plane_args(planes: dict[str, torch.Tensor | None]):
    """The launch's plane pointers (a missing plane is null) and their
    strides, 4 per plane (0 for a missing one), as ctypes arrays."""
    ptrs = (ctypes.c_void_p * len(planes))()
    strides = (ctypes.c_longlong * (4 * len(planes)))()
    for i, (name, x) in enumerate(planes.items()):
        if x is None:
            continue
        ptrs[i] = x.data_ptr()
        strides[4 * i:4 * i + 4] = plane_strides(name, x)
    return ptrs, strides
