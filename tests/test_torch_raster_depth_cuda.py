"""Kernel H (csrc/raster_depth.cu) against its plain PyTorch version and
against kernel A's fold on a CUDA device. Needs the card and the CUDA
toolkit: marked `cuda`, skipped elsewhere (`python -m pytest --noconftest
tests/test_torch_*_cuda.py` on a GPU machine without JAX).

H and its plain version evaluate the same float32 formulas with every
product and sum rounded separately, and H and kernel A share one fold
(csrc/raster_fold.cuh): ids and depths are expected bit-equal to both.
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_triangles
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import raster, raster_cuda
from test_torch_raster_cuda import edge_case_scene, screen_triangles

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,seed,cap,caps,shape", [
    (300, 0, 128, {}, (256, 192, 24, 128)),
    (2500, 3, 512, {"cap_small": 128, "hot_k": 6}, (256, 192, 24, 128)),
    (2500, 3, 512, {}, (256, 192, 12, 64)),
    (2500, 4, 512, {}, (320, 240, 60, 160)),
    (2500, 5, 512, {}, (480, 96, 24, 160)),
])
def test_depth_kernel_matches_plain_version_and_kernel_a(device, n, seed, cap, caps, shape):
    w, h, th, tw = shape
    clip, tris, payload = random_triangles(n, seed, device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    valid[::17] = False                      # invalid triangles never cover
    setup = raster.setup_triangles(clip, tris, valid, w, h)
    bins = raster.bin_triangles(setup, h // th, w // tw, th, tw, cap)
    before = LAUNCHES["raster_depth"]
    ids_k, z_k = raster_cuda.rasterize_depth(setup, bins, w, h, th, tw, **caps)
    torch.cuda.synchronize()
    assert LAUNCHES["raster_depth"] == before + 1
    ids_p, z_p = raster_cuda.rasterize_depth_reference(setup, bins, w, h, th, tw, **caps)
    assert torch.equal(ids_k, ids_p) and torch.equal(z_k, z_p)
    assert (ids_k >= 0).any() and (z_k[ids_k < 0] == 1.0).all()
    ids_a, z_a, _ = raster_cuda.rasterize_interp(
        setup, bins, raster_cuda.pack_rows64(setup, payload), w, h, th, tw, **caps)
    assert torch.equal(ids_k, ids_a) and torch.equal(z_k, z_a)


@pytest.mark.parametrize("kind", ["subpixel", "duplicates", "depth_bounds", "warp_edges"])
def test_depth_kernel_bit_equal_on_the_folds_hard_cases(device, kind):
    """H against its plain version and kernel A, bit for bit, on the scenes
    of test_torch_raster_cuda.edge_case_scene (all but 'warp_edges' with
    lists split into slices)."""
    clip, tris, w, h, (th, tw), cap = edge_case_scene(kind, device)
    n = tris.shape[0]
    setup = raster.setup_triangles(clip, tris, torch.ones(n, dtype=torch.bool, device=device),
                                   w, h)
    bins = raster.bin_triangles(setup, h // th, w // tw, th, tw, cap)
    got = raster_cuda.rasterize_depth(setup, bins, w, h, th, tw)
    want = raster_cuda.rasterize_depth_reference(setup, bins, w, h, th, tw)
    rows64 = raster_cuda.pack_rows64(setup, torch.zeros((n, 40), device=device))
    ids_a, z_a, _ = raster_cuda.rasterize_interp(setup, bins, rows64, w, h, th, tw)
    assert (want[0] >= 0).any() and int(bins.counts.max()) > raster_cuda.CHUNK
    for g, r, a in zip(got, want, (ids_a, z_a)):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))


@pytest.mark.parametrize("shape,y_offset,caps", [
    ((320, 240, 24, 160), 24, {}),
    ((256, 192, 12, 64), 48, {"cap_small": 128, "hot_k": 5}),
])
def test_depth_kernel_bit_equal_on_band_offsets(device, shape, y_offset, caps):
    w, h, th, tw = shape
    clip, tris, _ = random_triangles(3000, 6, device)
    setup = raster.setup_triangles(clip, tris, torch.ones(3000, dtype=torch.bool,
                                                          device=device), w, h + y_offset)
    bins = raster.bin_triangles(setup, h // th, w // tw, th, tw, 512, y_offset=y_offset)
    args = (setup, bins, w, h, th, tw, y_offset)
    got = raster_cuda.rasterize_depth(*args, **caps)
    want = raster_cuda.rasterize_depth_reference(*args, **caps)
    assert (want[0] >= 0).any()
    for g, r in zip(got, want):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


def test_kernels_rank_tied_hot_tiles_as_tile_limits(device):
    """Every tile lists the same 300 triangles (the same local pattern), so
    all 16 counts tie above cap_small: the kernels' own list limits must give
    the full list to the 5 lowest tile indices, as tile_limits (lax.top_k)."""
    rng = np.random.default_rng(9)
    local = rng.uniform((6, 6), (122, 18), (300, 1, 2)) + rng.uniform(-3, 3, (300, 3, 2))
    offsets = np.array([(tx * 128, ty * 24) for ty in range(8) for tx in range(2)], np.float64)
    xy = (local[None] + offsets[:, None, None]).reshape(-1, 3, 2)
    z = np.tile(rng.uniform(0.1, 0.9, (300, 3)), (16, 1))
    clip, tris = screen_triangles(xy, z, 256, 192, device)
    n = tris.shape[0]
    setup = raster.setup_triangles(clip, tris, torch.ones(n, dtype=torch.bool, device=device),
                                   256, 192)
    bins = raster.bin_triangles(setup, 8, 2, 24, 128, 512)
    caps = {"cap_small": 128, "hot_k": 5}
    assert (bins.counts == 300).all()
    limits = raster_cuda.tile_limits(bins.counts, 512, **caps).cpu()
    assert limits.tolist() == [300] * 5 + [128] * 11
    want = raster_cuda.rasterize_depth_reference(setup, bins, 256, 192, 24, 128, **caps)
    got = raster_cuda.rasterize_depth(setup, bins, 256, 192, 24, 128, **caps)
    rows64 = raster_cuda.pack_rows64(setup, torch.zeros((n, 40), device=device))
    ids_a, z_a, _ = raster_cuda.rasterize_interp(setup, bins, rows64, 256, 192, 24, 128, **caps)

    def local(ids):  # the winners as indices into the shared pattern
        return torch.where(ids >= 0, ids % 300, -1)

    # tile 0 folds its whole list, tile 15 only its first 128 entries
    assert not torch.equal(local(want[0][:24, :128]), local(want[0][-24:, 128:]))
    for g, r, a in zip(got, want, (ids_a, z_a)):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        assert torch.equal(a.view(torch.int32), r.view(torch.int32))


def test_depth_kernel_refuses_what_it_does_not_take(device):
    clip, tris, _ = random_triangles(30, 0, device)
    setup = raster.setup_triangles(clip, tris, torch.ones(30, dtype=torch.bool,
                                                          device=device), 256, 192)
    bins = raster.bin_triangles(setup, 8, 2, 24, 128, 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        raster_cuda.rasterize_depth(setup, raster.Bins(bins.ids[:, :100], bins.counts),
                                    256, 192, 24, 128)
    with pytest.raises(ValueError, match="whole number"):
        raster_cuda.rasterize_depth(setup, bins, 250, 192, 24, 128)
    wide = raster.bin_triangles(setup, 8, 1, 24, 1024, 128)
    with pytest.raises(ValueError, match="exceeds the kernel's 512"):
        raster_cuda.rasterize_depth(setup, wide, 1024, 192, 24, 1024)
