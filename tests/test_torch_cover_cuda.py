"""Kernel B (csrc/fused_cover.cu) against its plain PyTorch version on a
CUDA device: all four outputs (list, count, slot, covered) bit-equal. Needs
the card and the CUDA toolkit: marked `cuda`, skipped elsewhere. On a GPU
machine without JAX (tests/conftest.py imports it):
`python -m pytest --noconftest tests/test_torch_*_cuda.py`.
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
    # 32 rows (a 32x128 tile), caps at the kernel's limit of 128
    shape = (3, 2, 32, 128)
    return rng.integers(0, 300, shape), rng.random(shape) > 0.2, (128, 96), 24


@pytest.mark.parametrize("name", ["coherent", "adversarial", "empty", "fallback",
                                  "env_caps", "tall"])
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


def test_cover_kernel_refuses_what_it_does_not_take(device):
    p = torch.zeros((1, 1, 40, 128), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="1..32 rows"):
        cover_cuda.fused_cover(p, p > 0, (8,), 4)
    with pytest.raises(ValueError, match="group caps"):
        cover_cuda.fused_cover(p[:, :, :8], p[:, :, :8] > 0, (200,), 4)
