"""The port's whole frame against the JAX package's, on the CPU.

Two configurations, each with and without a sky, the JAX pipeline's
buffers carried across (state.state_from_jax) so both render from
bit-identical inputs; the frame must meet the JAX package's own fidelity
bar, rmse <= 1e-3 on uint8/255, and FrameStats must be identical:

* the planar one: the JAX pipeline with `use_pallas=True,
  use_tex_kernel=False, pallas_interpret=True` (fused raster+interpolation
  kernel in interpret mode, direct-atlas sampler, dense deferred shading),
  the port with `use_pallas=True` on a CPU device (the kernel's plain
  version), on `__graft_entry__._tiny_pipeline`'s scene at 128x96, tile
  12x64, bin_cap 512 (cap 512 > cap_small 128: the two-pass split runs);
* the default one on an accelerator: the JAX pipeline with `use_pallas=True,
  use_tex_kernel=True, pallas_interpret=True` (kernel A, the texture-cache
  plan with kernel B and kernel C, the env plan with kernel B and kernel D),
  the port with the same knobs on a CPU device (every kernel's plain
  version), at 256x96, tile 24x128, bin_cap 512.

The 1024-light path is checked on `tools/stress_scene` with 72 lights at
256x96 and `max_active_lights=128`, `use_pallas=True, use_tex_kernel=True`:
`light_tile` is set on both pipelines, the fused deferred pass is off, and
the unfused one runs the env cache (kernels B and F) and the tiled lights
(kernel G); the frames must agree within 1 LSB and rmse 1e-3, with equal
FrameStats.
"""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from chip_smoke import recording
from direct12pbrrenderer_tpu.config import RenderConfig
from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JaxPipeline
from direct12pbrrenderer_tpu.resource.resources import CubeMapResource
from direct12pbrrenderer_tpu.scene.camera import Camera
from direct12pbrrenderer_tpu.tools.stress_scene import build_stress_scene
from direct12pbrrenderer_tpu_torch.ops import (atlas_resolve_cuda, cover_cuda, env_resolve_cuda,
                                              lights_cuda)
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.state import state_from_jax
from test_env_isolation import _sky_cube

torch.set_num_threads(2)
RMSE_BAR = 1e-3
KNOBS = dict(tile_h=12, tile_w=64, bin_cap=512, prefilter_size=16, brdf_lut_size=32)


def jax_state(pipe) -> dict[str, np.ndarray]:
    """The JAX pipeline's buffers flattened to numpy in state.py's schema."""
    out = {}
    for k, v in pipe.buffers.items():
        if hasattr(v, "_fields"):                       # AtlasDevice
            out.update({f"{k}.{f}": np.asarray(getattr(v, f)) for f in v._fields})
        elif isinstance(v, tuple):                      # (LUT quad records, side)
            out[f"{k}.quad"], out[f"{k}.size"] = np.asarray(v[0]), np.asarray(v[1])
        elif hasattr(v, "shape"):
            out[k] = np.asarray(v)
        else:                                           # CubeMipAtlas
            out.update({f"{k}.{f}": np.asarray(getattr(v, f))
                        for f in ("offsets", "sizes_arr", "flat")})
    out["avg_luminance"] = np.asarray(pipe.avg_luminance)
    return out


def _scene(sky: bool):
    pipe, cam, cfg = graft._tiny_pipeline()
    scene = pipe.scene
    if sky:
        res = CubeMapResource("mem/sky")
        res.cubemap = _sky_cube(16)
        scene.set_skybox(res)
    return scene, cam, cfg


def _poses(cam, n=2):
    out, c = [], cam
    for _ in range(n):
        out.append(c)
        c = copy.deepcopy(c)
        c.rotate(0.0, 0.05, 0.02)
    return out


def _rmse(a, b):
    a = np.asarray(a, np.float64) / 255.0
    b = np.asarray(b, np.float64) / 255.0
    return float(np.sqrt(np.mean((a - b) ** 2)))


_JAX_RUNS = {}


def _jax_run(sky: bool, use_pallas: bool):
    """JAX frames (2 poses), stats and flattened state; cached per config."""
    key = (sky, use_pallas)
    if key not in _JAX_RUNS:
        scene, cam, cfg = _scene(sky)
        jp = JaxPipeline(scene, cfg, use_pallas=use_pallas, use_tex_kernel=False,
                         pallas_interpret=True, **KNOBS)
        state = jax_state(jp)
        frames, stats = [], []
        for c in _poses(cam):
            frames.append(np.asarray(jp.render(c)))
            stats.append(jp.last_stats)
        _JAX_RUNS[key] = (scene, cam, cfg, state, frames, stats, float(jp.avg_luminance))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("sky", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_frame_matches_jax_with_state(sky, use_pallas):
    scene, cam, cfg, state, frames, stats, avg = _jax_run(sky, use_pallas)
    tp = DeferredRenderPipeline(scene, cfg, use_pallas=use_pallas, device="cpu", **KNOBS)
    assert tp.use_pallas == use_pallas
    tp.load_state(state_from_jax(state, "cpu"))
    for c, want, want_stats in zip(_poses(cam), frames, stats):
        got = tp.render(c).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        assert (want.max(-1) > 16).mean() > 0.05  # a non-trivial frame
        assert _rmse(got, want) <= RMSE_BAR
        assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(want_stats)
    np.testing.assert_allclose(float(tp.avg_luminance), avg, rtol=1e-5)


def test_frame_with_own_precompute_matches_jax():
    """The port's own BRDF LUT / prefilter / SH / cube atlases in the frame."""
    scene, cam, cfg, _, frames, stats, _ = _jax_run(True, True)
    tp = DeferredRenderPipeline(scene, cfg, use_pallas=True, device="cpu", **KNOBS)
    for c, want, want_stats in zip(_poses(cam), frames, stats):
        assert _rmse(tp.render(c).numpy(), want) <= RMSE_BAR
        assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(want_stats)


def test_render_sequence_matches_per_frame():
    scene, cam, cfg = _scene(True)
    poses = _poses(cam, 3)
    a = DeferredRenderPipeline(scene, cfg, use_pallas=True, device="cpu", **KNOBS)
    b = DeferredRenderPipeline(scene, cfg, use_pallas=True, device="cpu", **KNOBS)
    seq = a.render_sequence(poses).numpy()
    per = np.stack([b.render(c).numpy() for c in poses])
    assert seq.shape == (3, cfg.height, cfg.width, 3)
    np.testing.assert_array_equal(seq, per)
    assert float(a.avg_luminance) == float(b.avg_luminance)


FUSED_KNOBS = dict(tile_h=24, tile_w=128, bin_cap=512, prefilter_size=16, brdf_lut_size=32)
_FUSED_RUNS = {}


def _fused_scene(sky: bool):
    pipe, cam, cfg = graft._tiny_pipeline(width=256, height=96, tile_h=24, tile_w=128)
    if sky:
        res = CubeMapResource("mem/sky")
        res.cubemap = _sky_cube(16)
        pipe.scene.set_skybox(res)
    return pipe.scene, cam, cfg


def _jax_fused_run(sky: bool):
    """The JAX default-path frames (2 poses), stats and state; cached."""
    if sky not in _FUSED_RUNS:
        scene, cam, cfg = _fused_scene(sky)
        jp = JaxPipeline(scene, cfg, use_pallas=True, use_tex_kernel=True,
                         pallas_interpret=True, **FUSED_KNOBS)
        assert jp.use_fused_gbuffer and jp.use_fused_deferred
        state = jax_state(jp)
        frames, stats = [], []
        for c in _poses(cam):
            frames.append(np.asarray(jp.render(c)))
            stats.append(jp.last_stats)
        _FUSED_RUNS[sky] = (scene, cam, cfg, state, frames, stats, float(jp.avg_luminance))
    return _FUSED_RUNS[sky]


@pytest.mark.parametrize("sky", [False, True])
def test_default_path_frame_matches_jax_fused_frame(sky):
    scene, cam, cfg, state, frames, stats, avg = _jax_fused_run(sky)
    assert "EnvCache.data" in state
    tp = DeferredRenderPipeline(scene, cfg, use_pallas=True, use_tex_kernel=True,
                                device="cpu", **FUSED_KNOBS)
    assert tp.use_fused_gbuffer and tp.use_fused_deferred
    tp.load_state(state_from_jax(state, "cpu"))
    for c, want, want_stats in zip(_poses(cam), frames, stats):
        got = tp.render(c).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        assert (want.max(-1) > 16).mean() > 0.05
        assert _rmse(got, want) <= RMSE_BAR
        assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(want_stats)
    np.testing.assert_allclose(float(tp.avg_luminance), avg, rtol=1e-5)


def test_default_path_frame_with_own_env_atlas_matches_jax():
    """The port's own precompute and env page atlas in the default frame."""
    scene, cam, cfg, _, frames, stats, _ = _jax_fused_run(True)
    tp = DeferredRenderPipeline(scene, cfg, use_pallas=True, use_tex_kernel=True,
                                device="cpu", **FUSED_KNOBS)
    for c, want, want_stats in zip(_poses(cam), frames, stats):
        assert _rmse(tp.render(c).numpy(), want) <= RMSE_BAR
        assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(want_stats)


def test_light_tile_frame_matches_jax():
    """The 1024-light path (tests/test_lights_pallas.py's pipeline scene):
    fused G-buffer, then the unfused deferred pass with the env cache and the
    tiled lights, against the JAX pipeline with the same knobs."""
    scene = build_stress_scene(cells_x=16, cells_y=8, n_lights=72)
    cfg = RenderConfig(width=256, height=96, max_instances=2, max_lights=128,
                       max_triangles=2048, max_vertices=2048)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 4, 10])
    cam.rotate(0, math.pi, 0.3)
    knobs = dict(tile_h=24, tile_w=128, bin_cap=256, max_active_lights=128, atlas_max_dim=64,
                 use_pallas=True, use_tex_kernel=True)
    jp = JaxPipeline(scene, cfg, pallas_interpret=True, **knobs)
    want = np.asarray(jp.render(cam))
    tp = DeferredRenderPipeline(scene, cfg, device="cpu", **knobs)
    with recording(env_resolve_cuda, "env_resolve") as env_calls, \
            recording(lights_cuda, "point_lights_kernel") as light_calls:
        got = tp.render(cam).numpy()
    for p in (jp, tp):
        assert p.light_tile == (24, 128) and p.light_cap == 128
        assert p.use_fused_gbuffer and not p.use_fused_deferred
    assert len(env_calls) == 1 and len(light_calls) == 1
    assert (want.max(-1) > 16).mean() > 0.05
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert _rmse(got, want) <= RMSE_BAR
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats)
    assert tp.last_stats.visible_lights > 32 and tp.last_stats.light_tile_overflow == 0


# Each case names what the pipeline must take for knobs whose path was once
# not ported: (light_tile, use_fused_deferred, env cache present, kernel E
# calls, kernel I row-scan calls) in one frame
UNPORTED = [
    # the planar texture-cache path without use_pallas (kernels B, E, F)
    (dict(use_tex_kernel=True), (None, False, True, 1, 0)),
    (dict(light_tile=(12, 64)), ((12, 64), False, False, 0, 0)),
    (dict(max_active_lights=128, use_pallas=True), ((12, 64), False, False, 0, 0)),
    # anisotropic filtering on the direct-atlas sampler
    (dict(texture_filter="anisotropic"), (None, False, False, 0, 0)),
    # kernel D's bfloat16 light loop on the fused deferred pass
    (dict(use_tex_kernel=True, use_pallas=True, **FUSED_KNOBS, fused_light_dtype="bfloat16"),
     (None, True, True, 0, 0)),
    # tex_caps="auto": the tap census sizes the caches at the first render
    (dict(use_tex_kernel=True, use_pallas=True, **FUSED_KNOBS, tex_caps="auto"),
     (None, True, True, 0, 0)),
    # caps above 128: the lo-half cover goes through kernel I
    (dict(use_tex_kernel=True, use_pallas=True, **FUSED_KNOBS, tex_caps=(156, 44)),
     (None, True, True, 0, 1)),
    # a cascade cap above 128: the cascade cover goes through kernel I
    (dict(use_tex_kernel=True, use_pallas=True, **FUSED_KNOBS, tex_cascade=(132, 8, 3)),
     (None, True, True, 0, 1)),
    (dict(use_tex_kernel=True, use_pallas=False, **FUSED_KNOBS), (None, False, True, 1, 0)),
    # the fused G-buffer without the fused deferred pass (tiles above 4096 px)
    ({**FUSED_KNOBS, "tile_h": 48, "use_tex_kernel": True, "use_pallas": True},
     (None, False, True, 0, 0)),
]


@pytest.mark.parametrize("knobs,item", UNPORTED,
                         ids=[f"knobs{i}" for i in range(len(UNPORTED))])
def test_unported_knobs_raise(knobs, item):
    """The knobs whose path was once not ported, and raised naming its
    ROADMAP item, take their path now: the planar texture cache (kernel E),
    caps above 128 (kernel I), anisotropic filtering, the unfused deferred
    pass with the tiled lights and/or the env cache, tex_caps="auto" (the
    tap census) and kernel D's bfloat16 light loop each render a frame
    through their kernels."""
    scene, cam, cfg = _fused_scene(False)
    light_tile, fused, env_cache, n_resolve, n_scan = item
    p = DeferredRenderPipeline(scene, cfg, device="cpu", **{**KNOBS, **knobs})
    assert (p.light_tile, p.use_fused_deferred, "EnvCache" in p.buffers) == item[:3]
    with recording(env_resolve_cuda, "env_resolve") as env_calls, \
            recording(lights_cuda, "point_lights_kernel") as light_calls, \
            recording(atlas_resolve_cuda, "atlas_resolve") as resolve_calls, \
            recording(cover_cuda, "fused_cover") as cover_calls:
        img = p.render(cam).numpy()
    # kernel I: kernel B's launch at a cap above 128
    scan_calls = [c for c in cover_calls if max(c[0][2]) > cover_cuda.WIDE_CAP]
    assert img.shape == (cfg.height, cfg.width, 3) and (img.max(-1) > 16).mean() > 0.05
    assert (len(light_calls), len(env_calls)) == (light_tile is not None,
                                                  env_cache and not fused)
    assert (len(resolve_calls), len(scan_calls)) == (n_resolve, n_scan)


def test_knob_defaults_follow_the_device():
    scene, _, cfg = _scene(False)
    p = DeferredRenderPipeline(scene, cfg, device="cpu", **KNOBS)
    assert not p.use_pallas and not p.use_tex_kernel and p.light_tile is None
    assert "EnvCache" not in p.buffers and not p.use_fused_deferred
    # the kernel needs whole 128-candidate chunks: the CPU turns the kernel
    # path off as the JAX package does, a CUDA device refuses (it never gives
    # way to the plain path); the check comes before any device allocation
    q = DeferredRenderPipeline(scene, cfg, device="cpu", use_pallas=True,
                               **{**KNOBS, "bin_cap": 500})
    assert not q.use_pallas
    for use_pallas in (True, None):
        with pytest.raises(ValueError, match="multiple of 128"):
            DeferredRenderPipeline(scene, cfg, device="cuda", use_pallas=use_pallas,
                                   **{**KNOBS, "bin_cap": 500})
    # the dense light sweep serves >64 lights where the kernel path is off
    r = DeferredRenderPipeline(scene, cfg, device="cpu", max_active_lights=128, **KNOBS)
    assert r.light_tile is None and r.light_cap == 128
