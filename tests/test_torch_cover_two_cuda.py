"""Kernel I (csrc/block_cover.cu: block_cover and pix_match) against its
plain PyTorch versions on a CUDA device, and the two-kernel route against
kernel B at caps up to 128: all outputs bit-equal. Needs the card and the
CUDA toolkit: marked `cuda`, skipped elsewhere (`python -m pytest
--noconftest tests/test_torch_*_cuda.py` on a GPU machine without JAX).
"""

import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu_torch.ops import cover_cuda, cover_two_cuda, texcache

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(name):
    """(pages, act, caps, block_cap) at the frame's shapes (g = 5, 24 rows)."""
    rng = np.random.default_rng(11)
    shape = (6, 5, 24, 128)
    if name == "wide":                 # up to 32 distinct pages a row: lists above 128
        return rng.integers(0, 2000, shape), rng.random(shape) > 0.1, (156,) * 5, 32
    if name == "coherent":             # row-coherent pages, the frame's regime
        base = rng.integers(0, 400, (6, 5, 1, 1))
        pages = base + np.arange(128)[None, None, None, :] // 16 + rng.integers(0, 2, shape)
        return pages, rng.random(shape) > 0.1, (92,) * 5, 16
    if name == "empty":
        pages = rng.integers(0, 40, shape)
        act = rng.random(shape) > 0.5
        act[0] = False
        act[2, 1:4] = False
        return pages, act, (140, 44, 140, 44, 132), 24
    if name == "rows_18":              # an 18-row tile (no padding of rows)
        shape = (4, 5, 18, 128)
        return rng.integers(0, 300, shape), rng.random(shape) > 0.2, (156, 44, 92, 44, 4), 32
    return rng.integers(0, 5000, shape), np.ones(shape, bool), (44,) * 5, 16


@pytest.mark.parametrize("name", ["wide", "coherent", "empty", "rows_18", "adversarial"])
def test_two_kernel_cover_matches_plain_versions(device, name):
    pages, act, caps, block_cap = _case(name)
    p = torch.as_tensor(pages.astype(np.int32), device=device)
    a = torch.as_tensor(act, device=device)
    before = (cover_two_cuda.block_cover.launches, cover_two_cuda.pix_match.launches)
    cand, slot_a = cover_two_cuda.block_cover(p, a, block_cap)
    torch.cuda.synchronize()
    want = cover_two_cuda.block_cover_reference(p, a, block_cap)
    assert torch.equal(cand, want[0]) and torch.equal(slot_a, want[1])
    rng = np.random.default_rng(5)
    slot_b = torch.as_tensor(rng.integers(0, 200, cand.shape).astype(np.int32), device=device)
    found_b = torch.as_tensor(rng.random(cand.shape) > 0.3, device=device)
    got = cover_two_cuda.pix_match(slot_a, slot_b, found_b, block_cap)
    want = cover_two_cuda.pix_match_reference(slot_a, slot_b, found_b, block_cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    after = (cover_two_cuda.block_cover.launches, cover_two_cuda.pix_match.launches)
    assert after == (before[0] + 1, before[1] + 1)
    # the whole route on the card vs on the CPU (every plain version)
    got = texcache._cover_and_match(p, a, caps, block_cap)
    want = texcache._cover_and_match(p.cpu(), a.cpu(), caps, block_cap)
    for g, w, what in zip(got, want, ("list", "count", "slot", "covered")):
        assert torch.equal(g.cpu(), w), what


@pytest.mark.parametrize("name", ["coherent", "empty", "adversarial"])
def test_two_kernel_route_equals_kernel_b_up_to_128(device, name):
    pages, act, caps, block_cap = _case(name)
    caps = tuple(min(c, 128) for c in caps)
    p = torch.as_tensor(pages.astype(np.int32), device=device)
    a = torch.as_tensor(act, device=device)
    want = cover_cuda.fused_cover(p, a, caps, block_cap)
    got = texcache._cover_and_match_2level(p, a, caps, block_cap)
    for g, w, what in zip(got, want, ("list", "count", "slot", "covered")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
