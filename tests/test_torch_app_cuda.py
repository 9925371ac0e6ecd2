"""The port's App on a CUDA device. Needs the card and the CUDA toolkit:
marked `cuda`, skipped elsewhere (`python -m pytest --noconftest
tests/test_torch_app_cuda.py` on a GPU machine without JAX).

* The App at the AppConfig defaults, at 384x160 (a 384-wide canvas) and at
  360x160 (padded to 384), on a tree built with the port's console
  (`chip_smoke.app_tree`: the stress terrain at 32x16 cells, a 2x2 grid of
  spheres, 8 lights, a sky): each frame launches kernel A once, B five
  times (three texture covers, the cascade's, the env cache's), C and D
  once, and no other kernel; its first frame is bit-equal to a pipeline
  built directly with the same knobs; one frame's kernel calls equal their
  plain versions at the kernels line's bars (`chip_smoke.hold_call`).
* `chip_smoke.app_fidelity` on that App at 360x160: its gate, the frame
  against the same pipeline with its kernels' plain versions, passes, and
  fails once kernel D's plain version is planted to differ.
* Kernels A and H on a canvas padded past the viewport's right edge (the
  triangles set up at 200x96, folded on 256x96): bit-equal to their plain
  versions, which cover the padding.
"""

import math

import pytest
import torch

import chip_smoke
from chip_smoke import APP_KERNELS, KERNELS, app_tree, hold_call, read_launches, recording, \
    reset_launches
from direct12pbrrenderer_tpu_torch.app.app import App, AppConfig
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.ops import (cover_cuda, raster_cuda, resolve_shade_cuda,
                                              shade_fused)
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.resource import loader as tloader
from direct12pbrrenderer_tpu_torch.scene.camera import Camera

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tree(device, tmp_path):
    old = tloader.ResourceLoader._instance
    app_tree(tmp_path / "T", tmp_path / "src", (32, 16), (2, 2))
    yield tmp_path / "T"
    tloader.ResourceLoader._instance = old


@pytest.mark.parametrize("width", [384, 360])
def test_app_frames_launch_a_b_c_d(device, tree, width):
    cfg = AppConfig(asset_root=str(tree), width=width, height=160, camera_pos=(0.0, 6.0, 18.0),
                    camera_pitch_deg=20.05)
    app = App(cfg)
    pipe, cam = app.pipeline, app.camera
    assert pipe.use_fused_gbuffer and pipe.use_fused_deferred and pipe.render_w == 384
    direct = DeferredRenderPipeline(
        app.scene, pipe.config, tile_h=cfg.tile_h, tile_w=cfg.tile_w, bin_cap=cfg.bin_cap,
        atlas_max_dim=cfg.atlas_max_dim, prefilter_size=cfg.prefilter_size,
        tex_caps=cfg.tex_caps, tex_cascade=cfg.tex_cascade, env_budget=cfg.env_budget,
        raster_caps=cfg.raster_caps, device=device)
    assert torch.equal(pipe.render(cam), direct.render(cam))
    assert pipe.last_stats == direct.last_stats
    torch.cuda.synchronize()
    reset_launches()
    for i in range(3):
        cam.rotate(0.0, math.radians(1.0), 0.0)
        pipe.render(cam, collect_stats=False)
    torch.cuda.synchronize()
    assert read_launches() == {k: 3 * APP_KERNELS.get(k, 0) for k in KERNELS}
    with recording(raster_cuda, "rasterize_interp") as a, \
            recording(cover_cuda, "fused_cover") as b, \
            recording(resolve_shade_cuda, "resolve_shade") as c, \
            recording(shade_fused, "deferred_kernel") as d:
        pipe.render(cam, collect_stats=False)
        torch.cuda.synchronize()
    for name, calls in (("raster_interp", a), ("fused_cover", b), ("resolve_shade", c),
                        ("deferred_shade", d)):
        assert len(calls) == APP_KERNELS[name]
        for args, kw in calls:
            hold_call("app-cuda", name, args, kw)


def test_kernels_a_and_h_cover_the_padded_canvas(device):
    scene = chip_smoke.stress_scene(16, 8, 16, 20.0)
    cfg = RenderConfig(200, 96, max_instances=2)
    pipe = DeferredRenderPipeline(scene, cfg, device=device, brdf_lut_size=16, bin_cap=512)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    setup, bins, rows64, _ = chip_smoke.frame_inputs(pipe, cam)
    assert (pipe.render_w, pipe.render_h) == (256, 96)
    args = (setup, bins, rows64, 256, 96, 24, 128)
    want = raster_cuda.rasterize_interp_reference(*args)
    assert (want[0][:, 200:] >= 0).any()         # the plain fold covers the padding
    chip_smoke.compare("padded", raster_cuda.rasterize_interp(*args), want)
    dargs = (setup, bins, 256, 96, 24, 128)
    chip_smoke.compare("padded", raster_cuda.rasterize_depth(*dargs, viewport=(200, 96)),
                       raster_cuda.rasterize_depth_reference(*dargs))


def test_app_fidelity_gates_on_the_plain_versions(device, tree, monkeypatch):
    cfg = AppConfig(asset_root=str(tree), width=360, height=160, camera_pos=(0.0, 6.0, 18.0),
                    camera_pitch_deg=20.05)
    app = App(cfg)
    line = chip_smoke.app_fidelity(app, app.pipeline, device)
    assert "vs its kernels' plain versions" in line and "use_pallas=False" in line
    plain = shade_fused.deferred_kernel_reference

    def planted(*args, **kw):
        out = plain(*args, **kw).clone()
        out[:, :3] += 0.25     # the colour planes; the counter plane is left
        return out

    monkeypatch.setattr(shade_fused, "deferred_kernel_reference", planted)
    with pytest.raises(SystemExit):
        chip_smoke.app_fidelity(app, app.pipeline, device)
