"""Fused two-level page cover — counterpart of
`ops/texcache.py::_fused_cover_pallas` (kernel B) and, at group caps above
128, of the two-kernel cover `_block_cover_pallas` + `_pix_match_pallas`
(kernel I): one launch serves every cap.

`fused_cover` launches the hand-written CUDA kernel `csrc/fused_cover.cu` for
CUDA tensors (persistent blocks that read the planes in place through their
strides, prefetch the next (tile, group) item and merge the rows' sorted
candidates; its header says why); for CPU tensors it runs
`fused_cover_reference`, the plain PyTorch version. There is no fallback
between the two: a CUDA input either launches the kernel or raises. Kernel
I's plain version is `texcache._cover_and_match_2level`, the TPU's two
kernels step for step; both plain versions agree bit for bit at every cap.

Per (tile, group) of `pages`/`act` (tiles, g, blocks, 128):
* each 128-pixel row keeps its `block_cap` smallest distinct active pages
  (the row's candidates; a pixel whose page is among them is matched);
* the tile's distinct candidates, ascending, are its page list; `count` is
  their number clamped to the group's cap, and the list is 0 past it;
* a matched pixel's slot is min(rank, cap - 1) and it is covered when its
  rank is below the cap and it is active. The match is not gated by `act`:
  an inactive pixel whose page equals a candidate gets that slot (never
  covered). An unmatched pixel gets slot 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.launch import Entry

SENTINEL = 2**31 - 1
WIDE_CAP = 128       # a launch with a larger cap stands for kernel I
WIDE = "cover_wide"  # the launch counter's name for kernel I (counted in B's too)
MAX_GROUPS = 16      # group caps ride the launch as a fixed-size struct


class _Caps(ctypes.Structure):
    _fields_ = [("v", ctypes.c_int * MAX_GROUPS)]


_LAUNCH = Entry("fused_cover", "fused_cover_launch", (*"psps", *"iiiii", _Caps, *"pppp"))


def fused_cover(pages: torch.Tensor, act: torch.Tensor, caps: tuple, block_cap: int):
    """-> (page_list (tiles, g, max(caps)) int32, count (tiles, g) int32,
    slot (tiles, g, blocks, 128) int32, covered (tiles, g, blocks, 128) bool)."""
    if pages.device.type == "cpu":
        return fused_cover_reference(pages, act, caps, block_cap)
    if pages.device.type != "cuda":
        raise ValueError(f"fused_cover: unsupported device {pages.device}")
    tiles, g, blocks, lanes = pages.shape
    cap_max = max(caps)
    if lanes != 128 or tuple(act.shape) != tuple(pages.shape):
        raise ValueError(f"pages/act must be (tiles, g, blocks, 128), got "
                         f"{tuple(pages.shape)}/{tuple(act.shape)}")
    if pages.dtype != torch.int32 or act.dtype != torch.bool:
        raise TypeError(f"pages must be int32 and act bool, got {pages.dtype}/{act.dtype}")
    if act.device != pages.device:
        raise ValueError(f"act on {act.device}, pages on {pages.device}")
    if len(caps) != g or g > MAX_GROUPS or min(caps) < 1:
        raise ValueError(f"need {g} <= {MAX_GROUPS} group caps of at least 1, got {caps}")
    if not 0 < blocks <= 32 or block_cap < 1:
        raise ValueError(f"the kernel takes 1..32 rows per tile and block_cap >= 1, got "
                         f"{blocks} rows, block_cap {block_cap}")
    # the kernel reads both planes in place through their strides (the
    # texture covers' arrive with the group innermost): no copy
    strides = [(ctypes.c_longlong * 4)(*x.stride()) for x in (pages, act)]
    dev = pages.device
    page_list = torch.empty((tiles, g, cap_max), dtype=torch.int32, device=dev)
    count = torch.empty((tiles, g), dtype=torch.int32, device=dev)
    slot = torch.empty(pages.shape, dtype=torch.int32, device=dev)
    cov = torch.empty(pages.shape, dtype=torch.bool, device=dev)
    cap_struct = _Caps()
    for i, c in enumerate(caps):
        cap_struct.v[i] = c
    _LAUNCH(dev, pages.data_ptr(), strides[0], act.data_ptr(), strides[1], tiles, g, blocks,
            block_cap, cap_max, cap_struct, page_list.data_ptr(), count.data_ptr(),
            slot.data_ptr(), cov.data_ptr(), also=(WIDE,) if cap_max > WIDE_CAP else ())
    return page_list, count, slot, cov


def fused_cover_reference(pages: torch.Tensor, act: torch.Tensor, caps: tuple,
                          block_cap: int):
    """Plain PyTorch version: `block_cap` rounds of a row min over the
    active, not yet taken pages, then the tile's distinct candidates ranked
    by a sort, then each pixel's slot through its row candidate's rank."""
    tiles, g, blocks, _ = pages.shape
    cap_max = max(caps)
    dev = pages.device
    cap_arr = torch.tensor(caps, dtype=torch.int32, device=dev)[None, :]      # (1, g)

    # row level: up to block_cap distinct pages per 128-pixel row, ascending
    vals = torch.where(act, pages, SENTINEL)
    slot_a = torch.full(pages.shape, block_cap, dtype=torch.int32, device=dev)
    cands = []
    for k in range(block_cap):
        m = vals.amin(-1, keepdim=True)                               # (t, g, b, 1)
        hit = pages == m
        slot_a = torch.where(hit & (m != SENTINEL), k, slot_a)
        vals = torch.where(hit, SENTINEL, vals)
        cands.append(m)
    cand = torch.cat(cands, -1).reshape(tiles, g, blocks * block_cap)  # j = r*B + k
    n = cand.shape[-1]

    # tile level: distinct candidates in ascending order, rank of each
    sv, sp = torch.sort(cand, dim=-1, stable=True)
    valid = sv != SENTINEL
    first = torch.cat([torch.ones_like(sv[..., :1], dtype=torch.bool),
                       sv[..., 1:] != sv[..., :-1]], -1) & valid
    rank_sorted = torch.cumsum(first.to(torch.int32), -1, dtype=torch.int32) - 1
    count = torch.minimum(first.sum(-1, dtype=torch.int32), cap_arr)
    width = max(n, cap_max) + 1
    buf = torch.zeros((tiles, g, width), dtype=torch.int32, device=dev)
    buf.scatter_(-1, torch.where(first, rank_sorted, width - 1).long(),
                 torch.where(first, sv, 0))
    lane = torch.arange(cap_max, device=dev)
    page_list = torch.where(lane < count[..., None], buf[..., :cap_max], 0)
    rank = torch.empty_like(rank_sorted).scatter_(-1, sp, rank_sorted)  # invalid: unused

    # per pixel: slot and coverage through the row candidate's rank
    rank_rb = rank.reshape(tiles, g, blocks, block_cap)
    matched = slot_a < block_cap
    rk = rank_rb.gather(-1, torch.clamp(slot_a, max=block_cap - 1).long())
    cap_pix = cap_arr[..., None, None]
    slot = torch.where(matched, torch.minimum(rk, cap_pix - 1), 0)
    covered = matched & (rk < cap_pix) & act
    return page_list, count, slot, covered
