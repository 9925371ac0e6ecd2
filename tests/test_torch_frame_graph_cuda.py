"""Every single-card path as one captured CUDA graph a frame, on the card:
1024x192 (8 x 8 tiles of 24x128) of a 16,384-triangle stress terrain with a
sky, so the binning stage takes the hierarchical binning. The paths
(PATHS): the default one (kernels A-D), the 1024-light path (A, B, C, F,
G), planar-tex at a 24x160 raster tile (A, B, E, F), anisotropic (A, the
anisotropic sampler, B, F), `use_tex_kernel=False` (A, the direct-atlas
sampler, the dense light sweep) and all-plain (no kernel).

* Every CUDA pipeline is captured, whatever its knobs; no CPU pipeline is.
* With the sync debug mode at "error", captured `render(collect_stats=False)`
  calls and one `render_sequence` raise nothing (no host sync), on each path.
* Captured frames are bit-equal to eager ones (`eager()`) over a yaw path,
  with equal FrameStats and exposure carry, and a replay adds the launches
  of one eager frame to the launch counter, on each path.
* `render_sequence` is bit-equal to as many `render` calls, with the same
  carry, on each path.
* Changing `fused_light_dtype` or `tex_caps` captures the frame again, and
  the frame follows the knob (bit-equal to the eager frame at the new knob).

Needs the card: marked `cuda`, skipped elsewhere (`python -m pytest
--noconftest tests/test_torch_*_cuda.py` on a GPU machine without JAX).
"""

import copy
import math

import pytest
import torch

from chip_smoke import stress_scene
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline, eager
from direct12pbrrenderer_tpu_torch.scene.camera import Camera

pytestmark = pytest.mark.cuda

W, H = 1024, 192
KNOBS = dict(tile_h=24, tile_w=128, bin_cap=1024, atlas_max_dim=256, prefilter_size=16,
             brdf_lut_size=32, tex_caps=(92, 44, None, (32, 16)))
# each path's knobs over KNOBS, and the kernels one of its frames launches
PATHS = {
    "default": ({}, {"raster_interp": 1, "fused_cover": 4, "resolve_shade": 1,
                     "deferred_shade": 1, "env_plan": 2, "tex_plan": 2}),
    "lights1k": (dict(max_active_lights=128),
                 {"raster_interp": 1, "fused_cover": 4, "resolve_shade": 1, "env_resolve": 1,
                  "point_lights": 1, "env_plan": 2, "tex_plan": 2}),
    "planar-tex": (dict(tile_w=160), {"raster_interp": 1, "fused_cover": 4,
                                      "atlas_resolve": 1, "env_resolve": 1, "env_plan": 2,
                                      "tex_plan": 2}),
    "anisotropic": (dict(texture_filter="anisotropic"),
                    {"raster_interp": 1, "fused_cover": 1, "env_resolve": 1, "env_plan": 2,
                     "aniso_sample": 1}),
    "use_tex_kernel=False": (dict(use_tex_kernel=False), {"raster_interp": 1}),
    "all-plain": (dict(use_pallas=False, use_tex_kernel=False), {}),
}
_SCENE = []


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cell():
    if not _SCENE:
        scene = stress_scene(128, 64, 32, 20.0)
        cfg = RenderConfig(W, H, max_instances=2)
        cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
        cam.move([0, 6, 18])
        cam.rotate(0, math.pi, 0.35)
        _SCENE.append((scene, cfg, cam))
    return _SCENE[0]


def _pipe(device, **knobs):
    scene, cfg, cam = _cell()
    return DeferredRenderPipeline(scene, cfg, device=device, **dict(KNOBS, **knobs)), cam


def _path(cam, n):
    out, c = [], cam
    for _ in range(n):
        c = copy.deepcopy(c)
        c.rotate(0.0, 0.01, 0.0)
        out.append(c)
    return out


def _eager_frame(pipe, cam):
    """(frame, stats, carry) of `cam` rendered eagerly from the pipeline's
    carry, which is left as it was."""
    carry = pipe.avg_luminance.clone()
    with eager():
        frame = pipe.render(cam)
    out = frame, pipe.last_stats, pipe.avg_luminance
    pipe.avg_luminance = carry
    return out


def test_every_cuda_pipeline_is_captured(device):
    for path, (knobs, _) in PATHS.items():
        assert _pipe(device, **knobs)[0].captured, path
    assert _pipe(device, fused_light_dtype="bfloat16", tex_caps="auto")[0].captured
    for knobs, _ in PATHS.values():
        assert not DeferredRenderPipeline(_cell()[0], _cell()[1], device="cpu",
                                          **dict(KNOBS, **knobs)).captured


@pytest.mark.parametrize("path", list(PATHS))
def test_captured_frames_make_no_host_sync(device, path):
    pipe, cam = _pipe(device, **PATHS[path][0])
    frames = _path(cam, 6)
    pipe.render(frames[0], collect_stats=False)   # the capture (and its warm-up)
    torch.cuda.synchronize()
    assert pipe.captured_frame is not None
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in frames[1:]:
            pipe.render(c, collect_stats=False)
        seq = pipe.render_sequence(frames)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert seq.shape == (len(frames), H, W, 3) and seq.dtype == torch.uint8


@pytest.mark.parametrize("path", list(PATHS))
def test_captured_frames_equal_eager_frames(device, path):
    knobs, kernels = PATHS[path]
    pipe, cam = _pipe(device, **knobs)
    pipe.render(cam)   # the capture: its warm-up frames launch too
    for c in _path(cam, 3):
        before = LAUNCHES.copy()
        want, want_stats, want_avg = _eager_frame(pipe, c)
        mid = LAUNCHES.copy()
        got = pipe.render(c)
        eager_counts = dict(mid - before)
        counts = dict(LAUNCHES - mid)
        assert torch.equal(got, want)
        assert pipe.last_stats == want_stats
        assert torch.equal(pipe.avg_luminance, want_avg)
        assert counts == eager_counts == kernels
    assert (got.max(-1).values > 16).float().mean() > 0.05   # a non-trivial frame


@pytest.mark.parametrize("path", list(PATHS))
def test_render_sequence_equals_render_calls(device, path):
    pipe, cam = _pipe(device, **PATHS[path][0])
    frames = _path(cam, 5)
    pipe.render(cam, collect_stats=False)
    carry = pipe.avg_luminance.clone()
    seq = pipe.render_sequence(frames)
    seq_avg = pipe.avg_luminance
    pipe.avg_luminance = carry
    loop = torch.stack([pipe.render(c, collect_stats=False) for c in frames])
    assert torch.equal(seq, loop)
    assert torch.equal(seq_avg, pipe.avg_luminance)


@pytest.mark.parametrize("knob, value", [("fused_light_dtype", "bfloat16"),
                                         ("tex_caps", (60, 28, None, (16, 8)))])
def test_a_changed_knob_captures_again(device, knob, value):
    pipe, cam = _pipe(device)
    pipe.render(cam)
    first = pipe.captured_frame
    setattr(pipe, knob, value)
    want, want_stats, _ = _eager_frame(pipe, cam)
    got = pipe.render(cam)
    assert pipe.captured_frame is not first and pipe.captured_frame.key != first.key
    assert torch.equal(got, want) and pipe.last_stats == want_stats
