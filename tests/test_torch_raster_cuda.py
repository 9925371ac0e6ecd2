"""Kernel A (csrc/raster_interp.cu) against its plain PyTorch version on a
CUDA device. Needs the card and the CUDA toolkit: marked `cuda`, skipped
elsewhere. On a GPU machine without JAX (tests/conftest.py imports it):
`python -m pytest --noconftest tests/test_torch_raster_cuda.py`.

Both sides evaluate the same float32 formulas with every product and sum
rounded separately, so winners, z and planes are expected bit-equal; the
bars are still the CPU tests' (id mismatch < 1e-4, z atol 1e-4, interp
rtol 1e-3 / atol 1e-4, material planes bit-equal).
"""

import numpy as np
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
    (300, 1, 128, {}, (256, 192, 24, 128)),
    (2500, 3, 512, {"cap_small": 128, "hot_k": 6}, (256, 192, 24, 128)),
    # tile heights that are not a multiple of the kernel's 8-row band
    (2500, 3, 512, {}, (256, 192, 12, 64)),
    (2500, 4, 512, {}, (320, 240, 60, 160)),
])
def test_kernel_matches_plain_version(device, n, seed, cap, caps, shape):
    w, h, th, tw = shape
    clip, tris, payload = random_triangles(n, seed, device)
    setup = raster.setup_triangles(clip, tris, torch.ones(n, dtype=torch.bool, device=device),
                                   w, h)
    bins = raster.bin_triangles(setup, h // th, w // tw, th, tw, cap)
    rows64 = raster_cuda.pack_rows64(setup, payload)
    before = raster_cuda.rasterize_interp.launches
    ids_k, z_k, pl_k = (t.cpu().numpy() for t in raster_cuda.rasterize_interp(
        setup, bins, rows64, w, h, th, tw, **caps))
    torch.cuda.synchronize()
    assert raster_cuda.rasterize_interp.launches == before + 1
    ids_p, z_p, pl_p = (t.cpu().numpy() for t in raster_cuda.rasterize_interp_reference(
        setup, bins, rows64, w, h, th, tw, **caps))
    mismatch = ids_k != ids_p
    assert mismatch.mean() < 1e-4
    agree = ~mismatch
    assert (agree & (ids_p >= 0)).any()
    np.testing.assert_array_equal(pl_k[8:, agree], pl_p[8:, agree])
    np.testing.assert_allclose(pl_k[:8, agree], pl_p[:8, agree], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(z_k[agree], z_p[agree], atol=1e-4)


@pytest.mark.parametrize("tile", [(24, 128), (12, 64)])
def test_pipeline_frame_through_kernel_matches_plain_path(device, tile):
    """A small frame of the use_tex_kernel=False path on the card through
    kernel A against use_pallas=False, at the JAX package's fidelity bar
    (rmse <= 1e-3 on uint8/255)."""
    import math

    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera
    from direct12pbrrenderer_tpu_torch.tools.stress_scene import build_stress_scene
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    scene = build_stress_scene(64, 32)
    cfg = RenderConfig(256, 192, max_instances=2)
    knobs = dict(tile_h=tile[0], tile_w=tile[1], bin_cap=4096, atlas_max_dim=256,
                 prefilter_size=16, brdf_lut_size=32, use_tex_kernel=False, device=device)
    kern = DeferredRenderPipeline(scene, cfg, use_pallas=True, **knobs)
    plain = DeferredRenderPipeline(scene, cfg, use_pallas=False, **knobs)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    before = raster_cuda.rasterize_interp.launches
    a = kern.render(cam).cpu().numpy().astype(np.float64) / 255.0
    b = plain.render(cam).cpu().numpy().astype(np.float64) / 255.0
    assert raster_cuda.rasterize_interp.launches == before + 1
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3
    assert kern.last_stats.bin_overflow == plain.last_stats.bin_overflow == 0


def test_kernel_exact_ties_go_to_the_earliest_list_entry(device):
    """Every triangle drawn twice (ids k and k + n): the kernel keeps the
    first copy at every covered pixel."""
    n = 300
    clip, tris, _ = random_triangles(n, 0, device)
    tris2 = torch.cat([tris, tris])
    setup = raster.setup_triangles(clip, tris2, torch.ones(2 * n, dtype=torch.bool,
                                                           device=device), 256, 192)
    bins = raster.bin_triangles(setup, 8, 2, 24, 128, 512)
    rows64 = raster_cuda.pack_rows64(setup, torch.zeros((2 * n, 40), device=device))
    ids_k = raster_cuda.rasterize_interp(setup, bins, rows64, 256, 192, 24, 128)[0]
    ids_p = raster_cuda.rasterize_interp_reference(setup, bins, rows64, 256, 192, 24, 128)[0]
    assert (ids_k >= 0).any() and (ids_k < n).all()
    assert torch.equal(ids_k, ids_p)
