"""Kernel B (csrc/fused_cover.cu) against its plain PyTorch version on a
CUDA device: all four outputs (list, count, slot, covered) bit-equal. Needs
the card and the CUDA toolkit: marked `cuda`, skipped elsewhere. On a GPU
machine without JAX (tests/conftest.py imports it):
`python -m pytest --noconftest tests/test_torch_*_cuda.py`.

Besides the frame's shapes, the cases of the persistent, merging kernel: 32
rows x block_cap 32 with all 1024 candidates distinct (the count clamps),
block_cap above a row's 128 pixels, pages at 2**31 - 2 (and inactive or
active pixels at 2**31 - 1, the sentinel), one page shared by every row, a
single live candidate, items alternating empty and full over more items than
the persistent grid holds, g = 16 groups, and planes the kernel reads in place
through their strides: misaligned, group-innermost and row-sliced views.
"""

import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu_torch.ops import cover_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(name):
    """(pages, act, caps, block_cap) for the cover shapes the frame uses
    (g = 5 slots, 24-row tiles; block_cap 4 / 16 / 8) and adversarial ones."""
    rng = np.random.default_rng(7)
    tiles, g, blocks = 6, 5, 24
    shape = (tiles, g, blocks, 128)
    if name == "coherent":             # row-coherent pages, the frame's regime
        base = rng.integers(0, 400, (tiles, g, 1, 1))
        pages = base + np.arange(128)[None, None, None, :] // 16 + rng.integers(0, 2, shape)
        act = rng.random(shape) > 0.1
        return pages, act, (92,) * g, 16
    if name == "adversarial":          # more distinct pages per row than block_cap
        return rng.integers(0, 5000, shape), np.ones(shape, bool), (44,) * g, 16
    if name == "empty":                # all-inactive tiles and groups
        pages = rng.integers(0, 40, shape)
        act = rng.random(shape) > 0.5
        act[0] = False
        act[2, 1:4] = False
        return pages, act, (92,) * g, 16
    if name == "fallback":             # the fallback cover: caps 4, block_cap 4
        return rng.integers(0, 7, shape), rng.random(shape) > 0.2, (4,) * g, 4
    if name == "env_caps":             # the env cover: per-group caps, block_cap 8
        return rng.integers(0, 60, shape), rng.random(shape) > 0.3, (32, 32, 32, 32, 16), 8
    if name == "tall":                 # 32 rows (a 32x128 tile), caps at the limit of 128
        shape = (3, 2, 32, 128)
        return rng.integers(0, 300, shape), rng.random(shape) > 0.2, (128, 96), 24
    if name == "distinct_1024":        # 32 rows x block_cap 32, every candidate distinct
        shape = (3, 2, 32, 128)
        pages = np.arange(32 * 128).reshape(32, 128)[None, None] * 7 + 3
        return np.broadcast_to(pages, shape), np.ones(shape, bool), (128, 100), 32
    if name == "block_cap_200":        # more rounds than a row has pixels
        shape = (4, 2, 6, 128)
        pages = rng.permutation(6 * 128 * 8)[:6 * 128].reshape(6, 128)
        act = rng.random(shape) > 0.05
        return np.broadcast_to(pages, shape), act, (128, 64), 200
    if name == "near_int_max":         # pages at 2**31 - 2, beside the sentinel 2**31 - 1
        pages = 2**31 - 1 - rng.integers(0, 4, shape)
        return pages, rng.random(shape) > 0.3, (92,) * g, 16
    if name == "one_shared_page":      # one page in every row of every item
        return np.full(shape, 77), rng.random(shape) > 0.5, (8,) * g, 4
    if name == "single_live":          # one active pixel per item
        act = np.zeros(shape, bool)
        act[:, :, 5, 17] = True
        return rng.integers(0, 40, shape), act, (44,) * g, 16
    if name == "alternating":          # items alternate empty and full, many per block
        shape = (700, 5, 24, 128)
        act = rng.random(shape) > 0.3
        act.reshape(-1, 24, 128)[::2] = False
        return rng.integers(0, 90, shape), act, (92,) * 5, 32
    # g = 16 groups, per-group caps
    shape = (4, 16, 24, 128)
    caps = tuple(int(c) for c in rng.integers(1, 129, 16))
    return rng.integers(0, 200, shape), rng.random(shape) > 0.4, caps, 16


@pytest.mark.parametrize("name", ["coherent", "adversarial", "empty", "fallback",
                                  "env_caps", "tall", "distinct_1024", "block_cap_200",
                                  "near_int_max", "one_shared_page", "single_live",
                                  "alternating", "g16"])
def test_cover_kernel_matches_plain_version(device, name):
    pages, act, caps, block_cap = _case(name)
    p = torch.as_tensor(pages.astype(np.int32), device=device)
    a = torch.as_tensor(act, device=device)
    before = cover_cuda.fused_cover.launches
    got = cover_cuda.fused_cover(p, a, caps, block_cap)
    torch.cuda.synchronize()
    assert cover_cuda.fused_cover.launches == before + 1
    want = cover_cuda.fused_cover_reference(p, a, caps, block_cap)
    for g, w, what in zip(got, want, ("list", "count", "slot", "covered")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g, w), what
    if name == "adversarial":
        assert not got[3].all()
    if name == "empty":
        assert not got[1][0].any() and not got[2][0].any()
    if name == "distinct_1024":
        assert (got[1] == torch.tensor(caps, device=device)).all()     # 1024 distinct, clamped
    if name in ("one_shared_page", "single_live"):
        assert (got[1] == 1).all()
    if name == "alternating":
        assert not got[1].flatten()[::2].any() and got[1].flatten()[1::2].all()


@pytest.mark.parametrize("layout", ["misaligned", "group_innermost", "row_slices"])
def test_cover_kernel_reads_strided_and_misaligned_views(device, layout):
    """The kernel reads its planes in place through their strides: views at
    an odd offset (4-byte loads), with the group innermost (the texture
    covers' layout) and rows sliced out of wider planes."""
    pages, act, caps, block_cap = _case("coherent")
    pages = torch.as_tensor(pages.astype(np.int32), device=device)
    act = torch.as_tensor(act, device=device)
    if layout == "misaligned":
        p_buf = torch.zeros(pages.numel() + 1, dtype=torch.int32, device=device)
        a_buf = torch.zeros(act.numel() + 3, dtype=torch.bool, device=device)
        p_buf[1:] = pages.flatten()
        a_buf[3:] = act.flatten()
        p, a = p_buf[1:].view(pages.shape), a_buf[3:].view(act.shape)
        assert p.data_ptr() % 16 and a.data_ptr() % 4
    elif layout == "group_innermost":
        p = pages.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        a = act.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        assert p.stride()[1] == 1
    else:
        p = torch.cat([pages, pages], 2)[:, :, ::2]
        a = torch.cat([act, act], 2)[:, :, ::2]
    before = cover_cuda.fused_cover.launches
    got = cover_cuda.fused_cover(p, a, caps, block_cap)
    torch.cuda.synchronize()
    assert cover_cuda.fused_cover.launches == before + 1
    for g, w in zip(got, cover_cuda.fused_cover_reference(p, a, caps, block_cap)):
        assert torch.equal(g, w)


def test_cover_kernel_refuses_what_it_does_not_take(device):
    p = torch.zeros((1, 1, 40, 128), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="1..32 rows"):
        cover_cuda.fused_cover(p, p > 0, (8,), 4)
    # any cap of at least 1 is taken (above 128 the launch is kernel I); 0 is not
    with pytest.raises(ValueError, match="group caps"):
        cover_cuda.fused_cover(p[:, :, :8], p[:, :, :8] > 0, (0,), 4)
