"""Kernel H (csrc/raster_depth.cu) against its plain PyTorch version and
against kernel A's fold on a CUDA device. Needs the card and the CUDA
toolkit: marked `cuda`, skipped elsewhere (`python -m pytest --noconftest
tests/test_torch_*_cuda.py` on a GPU machine without JAX).

H and its plain version evaluate the same float32 formulas with every
product and sum rounded separately, and H and kernel A share one fold
(csrc/raster_fold.cuh): ids and depths are expected bit-equal to both.
"""

import pytest
import torch

from chip_smoke import random_triangles
from direct12pbrrenderer_tpu_torch.ops import raster, raster_cuda

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
    before = raster_cuda.rasterize_depth.launches
    ids_k, z_k = raster_cuda.rasterize_depth(setup, bins, w, h, th, tw, **caps)
    torch.cuda.synchronize()
    assert raster_cuda.rasterize_depth.launches == before + 1
    ids_p, z_p = raster_cuda.rasterize_depth_reference(setup, bins, w, h, th, tw, **caps)
    assert torch.equal(ids_k, ids_p) and torch.equal(z_k, z_p)
    assert (ids_k >= 0).any() and (z_k[ids_k < 0] == 1.0).all()
    ids_a, z_a, _ = raster_cuda.rasterize_interp(
        setup, bins, raster_cuda.pack_rows64(setup, payload), w, h, th, tw, **caps)
    assert torch.equal(ids_k, ids_a) and torch.equal(z_k, z_a)


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
