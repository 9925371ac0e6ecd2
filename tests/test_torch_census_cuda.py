"""The tap census and `tex_caps="auto"` on a CUDA device. Needs the card
and the CUDA toolkit: marked `cuda`, skipped elsewhere (`python -m pytest
--noconftest tests/test_torch_*_cuda.py` on a GPU machine without JAX).

* On a 256x192 stress frame (albedo map on, a sky) the census runs the
  depth-only kernel H for its rasters; its counts equal, in every integer,
  the census with the plain fold (`use_pallas=False`), texture and env.
* The auto-sized frame's page covers (kernel B, five calls with the
  cascade) equal their plain versions bit for bit, and its resolve + shade
  (kernel C) meets the kernels line's bar (every value within 1.01/255, at
  most 0.2% of values differing).
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import recording, stress_scene
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.ops import cover_cuda, raster_cuda, resolve_shade_cuda
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.scene.camera import Camera
from direct12pbrrenderer_tpu_torch.tools import tap_census

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _auto_pipeline(device):
    scene = stress_scene(64, 32, 32, 20.0)
    cfg = RenderConfig(256, 192, max_instances=2)
    pipe = DeferredRenderPipeline(scene, cfg, device=device, tex_caps="auto", tile_h=24,
                                  tile_w=128, bin_cap=1024, atlas_max_dim=256,
                                  brdf_lut_size=32)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    return pipe, cam


def test_census_with_kernel_h_equals_plain_fold(device):
    pipe, cam = _auto_pipeline(device)
    assert pipe.use_pallas and pipe.use_tex_kernel and pipe.env_ids is not None
    before = raster_cuda.rasterize_depth.launches
    with_h = (tap_census.census_for_pose(pipe, cam), tap_census.env_census_for_pose(pipe, cam))
    torch.cuda.synchronize()
    assert raster_cuda.rasterize_depth.launches == before + 2
    pipe.use_pallas = False
    plain = (tap_census.census_for_pose(pipe, cam), tap_census.env_census_for_pose(pipe, cam))
    assert raster_cuda.rasterize_depth.launches == before + 2
    assert with_h == plain
    assert with_h[0]["lo"]["max"] > 0 and with_h[1]["group"]["max"] > 0


def test_auto_sized_frame_covers_and_resolve_match_plain(device):
    pipe, cam = _auto_pipeline(device)
    pipe.render(cam)                       # sizes the caches
    assert pipe.tex_cascade == (12, 8, 1) and len(pipe.tex_caps) == 4
    with recording(cover_cuda, "fused_cover") as covers, \
            recording(resolve_shade_cuda, "resolve_shade") as shades:
        pipe.render(cam)
        torch.cuda.synchronize()
    assert len(covers) == 5 and len(shades) == 1
    caps = sorted({max(args[2]) for args, _ in covers})
    assert 12 in caps and pipe.tex_caps[0] in caps
    for args, kw in covers:
        got = cover_cuda.fused_cover(*args, **kw)
        want = cover_cuda.fused_cover_reference(*args, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    (args, kw), = shades
    got = resolve_shade_cuda.resolve_shade(*args, **kw).cpu().numpy()
    want = resolve_shade_cuda.resolve_shade_reference(*args, **kw).cpu().numpy()
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.max() <= 1.01 / 255.0 and (diff > 1e-6).mean() < 2e-3
