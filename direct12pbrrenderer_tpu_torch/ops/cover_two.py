"""The two-level page cover's plain two-kernel form — counterpart of
`ops/texcache.py::_block_cover_pallas` and `_pix_match_pallas` (kernel I's
TPU sites).

The TPU needed two kernels for group caps above 128 only because its fused
cover writes the page list in one 128-lane row. On the card every cap goes
through kernel B's launch (`cover_cuda.fused_cover`, `csrc/fused_cover.cu`),
whose body has no such limit. These functions stay as kernel I's plain
version: `texcache._cover_and_match_2level` runs them around the tile-level
distinct sort (`texcache._distinct_by_sort`), the JAX package's two-kernel
structure step for step, and the tests and `chip_smoke.py` hold the launch
to it. Nothing on the card's path calls them.

* `block_cover_reference`: per 128-pixel row of pages/act (tiles, g,
  blocks, 128), `block_cap` rounds of a min over the row's active pages not
  yet taken. -> (cand (tiles, g, blocks, block_cap) int32, the round
  minima, SENTINEL once the row is exhausted; slotA (tiles, g, blocks, 128)
  int32, the round that took the pixel's page, `block_cap` for none). The
  mark is not gated by `act`: an inactive pixel whose page equals a
  candidate gets its round.
* `pix_match_reference`: per pixel, slot = slotB[row, slotA] and covered =
  foundB[row, slotA] where slotA < block_cap, slot 0 and not covered
  elsewhere (the caller gates covered by `act`).
"""

from __future__ import annotations

import torch

SENTINEL = 2**31 - 1


def block_cover_reference(pages: torch.Tensor, act: torch.Tensor, block_cap: int):
    """The row scan: the same rounds over whole (tiles, g, blocks, 128)
    planes."""
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
    """The per-pixel match: a gather along each row's block_cap entries."""
    matched = (slot_a >= 0) & (slot_a < block_cap)
    idx = torch.clamp(slot_a, 0, block_cap - 1).long()
    slot = torch.where(matched, slot_b.gather(-1, idx), 0)
    return slot, matched & found_b.gather(-1, idx)
