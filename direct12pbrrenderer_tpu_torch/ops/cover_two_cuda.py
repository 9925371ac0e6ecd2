"""Two-kernel page cover for group caps above 128 — counterpart of
`ops/texcache.py::_block_cover_pallas` and `_pix_match_pallas` (kernel I).

`block_cover` and `pix_match` launch the two hand-written CUDA kernels of
`csrc/block_cover.cu` for CUDA tensors; for CPU tensors they run their plain
PyTorch versions (`block_cover_reference`, `pix_match_reference`). There is
no fallback between the two: a CUDA input either launches the kernel or
raises. `texcache._cover_and_match_2level` runs them around the tile-level
distinct sort (`texcache._distinct_by_sort`).

* `block_cover`: per 128-pixel row of pages/act (tiles, g, blocks, 128),
  `block_cap` rounds of a min over the row's active pages not yet taken.
  -> (cand (tiles, g, blocks, block_cap) int32, the round minima, SENTINEL
  once the row is exhausted; slotA (tiles, g, blocks, 128) int32, the round
  that took the pixel's page, `block_cap` for none). The mark is not gated by
  `act`: an inactive pixel whose page equals a candidate gets its round.
* `pix_match`: per pixel, slot = slotB[row, slotA] and covered =
  foundB[row, slotA] where slotA < block_cap, slot 0 and not covered
  elsewhere (the caller gates covered by `act`).
"""

from __future__ import annotations

import ctypes

import torch

SENTINEL = 2**31 - 1
_KERNEL = "block_cover"


def _check(name, x, shape, dtype, device):
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on {device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")


def block_cover(pages: torch.Tensor, act: torch.Tensor, block_cap: int):
    """-> (cand (tiles, g, blocks, block_cap) int32, slotA (tiles, g, blocks,
    128) int32)."""
    if pages.device.type == "cpu":
        return block_cover_reference(pages, act, block_cap)
    if pages.device.type != "cuda":
        raise ValueError(f"block_cover: unsupported device {pages.device}")
    if pages.dim() != 4 or pages.shape[-1] != 128 or block_cap < 1:
        raise ValueError(f"pages must be (tiles, g, blocks, 128) and block_cap >= 1, got "
                         f"{tuple(pages.shape)}, {block_cap}")
    _check("pages", pages, pages.shape, torch.int32, pages.device)
    _check("act", act, pages.shape, torch.bool, pages.device)
    pages, act = pages.contiguous(), act.contiguous()
    n_rows = pages.numel() // 128
    cand = torch.empty((*pages.shape[:3], block_cap), dtype=torch.int32, device=pages.device)
    slot = torch.empty(pages.shape, dtype=torch.int32, device=pages.device)
    lib = _library()
    with torch.cuda.device(pages.device):
        err = lib.block_cover_launch(pages.data_ptr(), act.data_ptr(), n_rows, block_cap,
                                     cand.data_ptr(), slot.data_ptr(),
                                     torch.cuda.current_stream(pages.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"block_cover kernel launch failed: CUDA error {err}")
        block_cover.launches += 1
    return cand, slot


block_cover.launches = 0  # kernel launches in this process (reset by callers)


def pix_match(slot_a: torch.Tensor, slot_b: torch.Tensor, found_b: torch.Tensor,
              block_cap: int):
    """slot_a (tiles, g, blocks, 128) int32, slot_b (tiles, g, blocks,
    block_cap) int32, found_b the same shape bool -> (slot (tiles, g, blocks,
    128) int32, covered bool)."""
    if slot_a.device.type == "cpu":
        return pix_match_reference(slot_a, slot_b, found_b, block_cap)
    if slot_a.device.type != "cuda":
        raise ValueError(f"pix_match: unsupported device {slot_a.device}")
    if slot_a.dim() != 4 or slot_a.shape[-1] != 128 or block_cap < 1:
        raise ValueError(f"slot_a must be (tiles, g, blocks, 128) and block_cap >= 1, got "
                         f"{tuple(slot_a.shape)}, {block_cap}")
    dev = slot_a.device
    row_shape = (*slot_a.shape[:3], block_cap)
    _check("slot_a", slot_a, slot_a.shape, torch.int32, dev)
    _check("slot_b", slot_b, row_shape, torch.int32, dev)
    _check("found_b", found_b, row_shape, torch.bool, dev)
    slot_a, slot_b, found_b = (x.contiguous() for x in (slot_a, slot_b, found_b))
    slot = torch.empty(slot_a.shape, dtype=torch.int32, device=dev)
    cov = torch.empty(slot_a.shape, dtype=torch.bool, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.pix_match_launch(slot_a.data_ptr(), slot_b.data_ptr(), found_b.data_ptr(),
                                   slot_a.numel() // 128, block_cap, slot.data_ptr(),
                                   cov.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"pix_match kernel launch failed: CUDA error {err}")
        pix_match.launches += 1
    return slot, cov


pix_match.launches = 0  # kernel launches in this process (reset by callers)


def _library() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_KERNEL)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, args in ((lib.block_cover_launch, [p, p, ll, i, p, p, p]),
                     (lib.pix_match_launch, [p, p, p, ll, i, p, p, p])):
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------- plain versions ----
def block_cover_reference(pages: torch.Tensor, act: torch.Tensor, block_cap: int):
    """Plain PyTorch version of block_cover: the same rounds over whole
    (tiles, g, blocks, 128) planes."""
    vals = torch.where(act, pages, SENTINEL)
    slot = torch.full(pages.shape, block_cap, dtype=torch.int32, device=pages.device)
    cands = []
    for k in range(block_cap):
        m = vals.amin(-1, keepdim=True)                               # (t, g, b, 1)
        hit = pages == m
        slot = torch.where(hit & (m != SENTINEL), k, slot)
        vals = torch.where(hit, SENTINEL, vals)
        cands.append(m)
    return torch.cat(cands, -1).to(torch.int32), slot


def pix_match_reference(slot_a: torch.Tensor, slot_b: torch.Tensor, found_b: torch.Tensor,
                        block_cap: int):
    """Plain PyTorch version of pix_match: a gather along each row's
    block_cap entries."""
    matched = (slot_a >= 0) & (slot_a < block_cap)
    idx = torch.clamp(slot_a, 0, block_cap - 1).long()
    slot = torch.where(matched, slot_b.gather(-1, idx), 0)
    return slot, matched & found_b.gather(-1, idx)
