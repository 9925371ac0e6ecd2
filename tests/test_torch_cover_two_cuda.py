"""Kernel I on the card: kernel B's launch (`cover_cuda.fused_cover`,
csrc/fused_cover.cu) at group caps above 128, against its plain version, the
TPU's two-kernel structure (`texcache._cover_and_match_2level`) on the CPU:
all four outputs bit-equal, with the planes passed contiguous and
group-innermost (strides (t, 1, 128 g, g), as the texture covers' arrive);
exactly one launch a call, counted as wide; no tensor op in a call but its
outputs' allocation. Also the two-level plain route against kernel B at caps
up to 128 on the card. Needs the card and the CUDA toolkit: marked `cuda`,
skipped elsewhere (`python -m pytest --noconftest tests/test_torch_*_cuda.py`
on a GPU machine without JAX).
"""

import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu_torch.ops import cover_cuda, texcache

pytestmark = pytest.mark.cuda

CASES = ["wide", "per_group", "coherent", "empty", "rows_18", "adversarial"]


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
    if name == "per_group":            # per-group caps, tile counts above most of them
        return (rng.integers(0, 3000, shape), rng.random(shape) > 0.1,
                (156, 200, 130, 156, 300), 16)
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


def _wide_case(name):
    """`_case(name)` with its first group's cap lifted above 128 where no cap
    is (the other groups' caps still clamp)."""
    pages, act, caps, block_cap = _case(name)
    if max(caps) <= 128:
        caps = (caps[0] + 128,) + caps[1:]
    return pages.astype(np.int32), act, caps, block_cap


def _on_card(x, device, layout):
    """x (tiles, g, blocks, 128) on the card, contiguous or with the group
    innermost (strides (t, 1, 128 g, g))."""
    t = torch.as_tensor(x, device=device)
    if layout == "contiguous":
        return t
    return t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def _counts():
    return cover_cuda.fused_cover.launches, cover_cuda.fused_cover.wide_launches


@pytest.mark.parametrize("layout", ["contiguous", "group_innermost"])
@pytest.mark.parametrize("name", CASES)
def test_wide_launch_matches_two_kernel_plain_route(device, name, layout):
    pages, act, caps, block_cap = _wide_case(name)
    p, a = _on_card(pages, device, layout), _on_card(act, device, layout)
    if layout == "group_innermost":
        g = pages.shape[1]
        assert p.stride() == (pages[0].size, 1, 128 * g, g) and a.stride() == p.stride()
    before = _counts()
    got = texcache._cover_and_match(p, a, caps, block_cap)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1)
    want = texcache._cover_and_match_2level(torch.as_tensor(pages), torch.as_tensor(act), caps,
                                            block_cap)
    for g_, w, what in zip(got, want, ("list", "count", "slot", "covered")):
        assert g_.dtype == w.dtype and g_.shape == w.shape, what
        assert torch.equal(g_.cpu(), w), what
    if name in ("wide", "per_group"):  # tile lists really exceed 128 pages
        assert (want[1] > 128).any()


def test_wide_launch_dispatches_only_its_outputs(device):
    """One call on group-innermost planes dispatches no tensor op but its
    outputs' allocation (no copy), and a complete trace of ten calls holds
    only the kernel."""
    from chip_smoke import OUTPUT_OPS, device_spans, dispatched_ops

    pages, act, caps, block_cap = _wide_case("per_group")
    p, a = _on_card(pages, device, "group_innermost"), _on_card(act, device, "group_innermost")

    def call():
        return cover_cuda.fused_cover(p, a, caps, block_cap)

    ops = dispatched_ops(call)
    assert ops and all(op in OUTPUT_OPS for op in ops), ops
    names = {n for n, _ in device_spans(call, 10, "fused_cover")}
    assert all("fused_cover_kernel" in n for n in names), names


@pytest.mark.parametrize("name", ["coherent", "empty", "adversarial"])
def test_two_kernel_route_equals_kernel_b_up_to_128(device, name):
    pages, act, caps, block_cap = _case(name)
    caps = tuple(min(c, 128) for c in caps)
    p = torch.as_tensor(pages.astype(np.int32), device=device)
    a = torch.as_tensor(act, device=device)
    before = _counts()
    want = cover_cuda.fused_cover(p, a, caps, block_cap)
    assert _counts() == (before[0] + 1, before[1])      # not a wide launch
    got = texcache._cover_and_match_2level(p, a, caps, block_cap)
    for g, w, what in zip(got, want, ("list", "count", "slot", "covered")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
