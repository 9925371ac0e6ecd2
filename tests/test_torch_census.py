"""The port's tap census and `tex_caps="auto"` against the JAX package.

* `texcache.tap_census` and the `recommend_*` folds on the same numpy tap
  streams as the JAX package's (its census is XLA code: no kernel, no
  interpret mode): exact integers, means within 1e-6, at a 24x128 tile and
  a 12x64 tile, whose 6 pixel rows per tile the JAX tiling pads to 8 (the
  padded rows count 0 pages and enter the row percentile).
* `envcache.tap_census` and `recommend_budget` on the deferred pass's env
  tap groups.
* `gbuffer.tap_query` with both size lookups: tex ids, uv and the active
  mask exact, the LOD (a float32 log2, which the two libraries may round an
  ulp or two apart) within the repo's transcendental bar, rtol 1e-5 / atol
  1e-6 (test_torch_common_ibl.py).
* `tools/tap_census.run_census` on the port's pipeline against the JAX
  pipeline's `_ensure_auto_caps` (its census runs the plain XLA raster) on
  test_auto_caps.py's stress scene and pose, with the albedo map on and a
  sky so every census counts pages: equal censuses pose by pose and equal
  sized knobs.
* The port's `tex_caps="auto"` frame on test_auto_caps.py's scene, with
  and without its albedo map: sized once at the first render (a copy of
  the camera probed), the cascade on, rmse <= 1e-3 against the all-plain
  pipeline (the JAX package's bar, test_auto_caps.py), later renders and
  `render_sequence` without a second census.
"""

import copy
import math
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import envcache as jenv
from direct12pbrrenderer_tpu.ops import gbuffer as jgbuffer
from direct12pbrrenderer_tpu.ops import shading as jshading
from direct12pbrrenderer_tpu.ops import texcache as jtex
from direct12pbrrenderer_tpu_torch.ops import envcache, gbuffer, texcache
from direct12pbrrenderer_tpu_torch.ops.cover_two import SENTINEL
from test_torch_envcache import _build
from test_torch_texcache import _atlases

torch.set_num_threads(2)


def _tap_stream(rng, h, w, n_tex):
    """A tap stream with coherent regions (smooth uv, one texture per slot)
    and noisy ones (random uv, lod and textures), some rows inactive."""
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    u = (xx * 0.9 + 0.05 * rng.random((h, w))).astype(np.float32)
    v = (yy * 0.9).astype(np.float32)
    noisy = rng.random((h, w)) < 0.3
    u = np.where(noisy, rng.random((h, w)) * 4 - 2, u).astype(np.float32)
    tex = np.broadcast_to(np.arange(5, dtype=np.int32) % n_tex, (h, w, 5)).copy()
    tex = np.where(noisy[..., None], rng.integers(0, n_tex, (h, w, 5)), tex).astype(np.int32)
    lod = np.where(noisy[..., None], rng.random((h, w, 5)) * 6 - 1,
                   1.3).astype(np.float32)
    active = rng.random((h, w, 5)) > 0.2
    active[rng.random(h) < 0.25] = False          # whole rows without taps
    return tex, u, v, lod, active


def _assert_census_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys(), k
        for stat, x in want[k].items():
            if stat == "mean":
                assert got[k][stat] == pytest.approx(x, abs=1e-6), (k, stat)
            else:
                assert got[k][stat] == x and type(got[k][stat]) is int, (k, stat)


@pytest.mark.parametrize("tile,filt", [((24, 128), "trilinear"), ((12, 64), "trilinear"),
                                       ((24, 128), "bilinear")])
def test_tex_census_and_recommendations_match_jax(tile, filt):
    rng = np.random.default_rng(7)
    specs = [(64, 64, False), (32, 16, True), (128, 64, False), (256, 128, True)]
    jatlas, atlas = _atlases(rng, specs)
    frames_j, frames_t = [], []
    for seed in (1, 2):
        tex, u, v, lod, active = _tap_stream(np.random.default_rng(seed), 48, 256, len(specs))
        kw = dict(filter=filt, tile_h=tile[0], tile_w=tile[1], cap_lo=36, cap_hi=20)
        frames_j.append(jtex.tap_census(jatlas, *(jnp.asarray(a) for a in
                                                  (tex, u, v, lod, active)), **kw))
        frames_t.append(texcache.tap_census(atlas, *(torch.as_tensor(a) for a in
                                                     (tex, u, v, lod, active)), **kw))
        _assert_census_equal(frames_t[-1], frames_j[-1])
    assert frames_t[0]["lo"]["max"] > 4          # demand well above one page
    for headroom in (1.0, 1.5, 2.0):
        assert (texcache.recommend_caps(frames_t, headroom)
                == jtex.recommend_caps(frames_j, headroom))
        assert (texcache.recommend_budget(frames_t, headroom)
                == jtex.recommend_budget(frames_j, headroom))
    if filt == "trilinear":
        assert (texcache.recommend_block_caps(frames_t)
                == jtex.recommend_block_caps(frames_j))
        assert (texcache.recommend_block_caps(frames_t, headroom=0, lo_max=64, hi_max=64)
                == jtex.recommend_block_caps(frames_j, headroom=0, lo_max=64, hi_max=64))
    if tile == (12, 64):
        # the padded rows matter: without them the row percentile moves
        tex, u, v, lod, active = (torch.as_tensor(a) for a in _tap_stream(
            np.random.default_rng(1), 48, 256, len(specs)))
        bw, bh, pb, _, mips, _, _ = texcache._mip_plan(atlas, tex, lod, True)
        page = texcache._tap_addresses(bw, bh, texcache.select_mip(pb, mips[0]), mips[0],
                                       u[..., None].expand(tex.shape),
                                       v[..., None].expand(tex.shape))[0]

        def tile_g(x):
            return texcache._tile(x.permute(2, 0, 1), *tile)

        rows = torch.where(tile_g(active), tile_g(page), SENTINEL).reshape(-1, 128)
        unpadded = int(np.percentile(texcache._distinct_counts(rows), 99.9))
        assert unpadded != frames_t[0]["lo"]["row_p999"]


def test_env_census_and_budget_match_jax():
    bt, ids = _build(envcache.FloatAtlasBuilder, 5, env_size=64, env_mips=5)
    bj, _ = _build(jenv.FloatAtlasBuilder, 5, env_size=64, env_mips=5)
    env_ids = (*ids, True)
    frames_j, frames_t = [], []
    for seed in (3, 4):
        rng = np.random.default_rng(seed)
        h, w = 48, 256
        refl = rng.normal(size=(h, w, 3)).astype(np.float32)
        refl /= np.linalg.norm(refl, axis=-1, keepdims=True)
        ray = (np.array([0.3, 0.2, 1.0], np.float32)
               + 0.15 * rng.normal(size=(h, w, 3))).astype(np.float32)
        ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
        rough = (rng.random((h, w)) * 0.6).astype(np.float32)
        ndv = rng.random((h, w)).astype(np.float32)
        mask = rng.random((h, w)) > 0.3
        tex, mip, u, v, act, _, caps, _, _ = jshading.env_tap_groups(
            *(jnp.asarray(a) for a in (refl, ray, rough, ndv, mask)), env_ids)
        stacks = [np.asarray(a) for a in (tex, mip, u, v, act)]
        frames_j.append(jenv.tap_census(bj.build(), *(jnp.asarray(a) for a in stacks),
                                        tile_h=24, tile_w=128, caps=caps))
        frames_t.append(envcache.tap_census(bt.build("cpu"),
                                            *(torch.as_tensor(a) for a in stacks),
                                            tile_h=24, tile_w=128, caps=caps))
        _assert_census_equal(frames_t[-1], frames_j[-1])
    assert frames_t[0]["group"]["max"] > 4
    for headroom in (1.0, 1.5):
        assert (envcache.recommend_budget(frames_t, headroom)
                == jenv.recommend_budget(frames_j, headroom))


@pytest.mark.parametrize("use_tex_kernel", [True, False])
def test_tap_query_matches_jax(use_tex_kernel):
    rng = np.random.default_rng(9)
    jatlas, atlas = _atlases(rng, [(64, 64, False), (32, 16, True), (128, 64, False)])
    h, w = 24, 64
    interp = rng.normal(size=(h, w, 8)).astype(np.float32)
    interp[..., 0:2] = rng.random((h, w, 2)) * 3
    matrow = rng.random((h, w, 16)).astype(np.float32)
    matrow[..., 11:16] = rng.integers(-1, 3, (h, w, 5))
    mask = rng.random((h, w)) > 0.2
    want = jgbuffer.tap_query(jnp.asarray(interp), jnp.asarray(matrow), jnp.asarray(mask),
                              jatlas, use_tex_kernel=use_tex_kernel)
    got = gbuffer.tap_query(torch.as_tensor(interp), torch.as_tensor(matrow),
                            torch.as_tensor(mask), atlas, use_tex_kernel=use_tex_kernel)
    for name, g, x in zip(("tex", "u", "v", "lod5", "active"), got, want):
        x = np.asarray(x)
        assert g.dtype == {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
                           np.dtype(bool): torch.bool}[x.dtype], name
        if name == "lod5":
            np.testing.assert_allclose(g.numpy(), x, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), x, err_msg=name)


def _pkg_scene(pkg):
    """test_auto_caps.py's stress scene with its albedo map switched on and a
    small sky, built with package `pkg`'s own classes."""
    from test_torch_host_copies import _module, _sky

    scene = _module(pkg, "tools.stress_scene").build_stress_scene(cells_x=24, cells_y=12,
                                                                 n_lights=4)
    for sm in scene.models:
        for mat in sm.model.materials:
            mat.set_parameter("UseAlbedoMap", True)
    scene.set_skybox(_sky(pkg, 16))
    cfg = _module(pkg, "config").RenderConfig(width=128, height=96, max_instances=2,
                                              max_lights=8)
    cam = _module(pkg, "scene.camera").Camera(cfg.fov, cfg.width, cfg.height, cfg.near,
                                              cfg.far)
    cam.move([3.0, 4.0, 9.0])
    cam.rotate(0.0, np.pi * 0.9, 0.28)
    return scene, cfg, cam


KNOBS = dict(tile_h=24, tile_w=128, bin_cap=1024, atlas_max_dim=128, prefilter_size=8,
             brdf_lut_size=16)


def test_run_census_and_auto_knobs_match_jax():
    from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JPipe
    from direct12pbrrenderer_tpu.tools import tap_census as jcensus
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer_tpu_torch.tools import tap_census

    jscene, jcfg, jcam = _pkg_scene("direct12pbrrenderer_tpu")
    jpipe = JPipe(jscene, jcfg, tex_caps="auto", use_tex_kernel=True, pallas_interpret=True,
                  **KNOBS)
    recorded, real = [], jcensus.run_census

    def run_and_record(*args, **kw):
        out = real(*args, **kw)
        recorded.append(out)
        return out

    with mock.patch.object(jcensus, "run_census", run_and_record):
        jpipe._ensure_auto_caps(jcam)
    (want_c, want_caps, want_env), = recorded

    scene, cfg, cam = _pkg_scene("direct12pbrrenderer_tpu_torch")
    pipe = DeferredRenderPipeline(scene, cfg, tex_caps="auto", use_tex_kernel=True,
                                  device="cpu", **KNOBS)
    assert pipe._auto_caps and pipe.tex_caps is None
    got_c, got_caps, got_env = tap_census.run_census(pipe, copy.deepcopy(cam), poses=3,
                                                     yaw_sweep_deg=30.0)
    assert len(got_c) == len(want_c) == 3 and len(got_env) == len(want_env) == 3
    for g, w in zip(got_c + got_env, want_c + want_env):
        _assert_census_equal(g, w)
    assert want_c[0]["lo"]["max"] > 0 and want_env[0]["group"]["max"] > 0
    assert got_caps == want_caps

    pipe._ensure_auto_caps(cam)
    assert not pipe._auto_caps
    assert pipe.tex_caps == jpipe.tex_caps
    assert pipe.env_budget == jpipe.env_budget
    assert pipe.tex_cascade == jpipe.tex_cascade == (12, 8, 1)


def _gate_scene(albedo):
    """test_auto_caps.py's scene, config and pose (no sky), with the albedo
    map switched on or off."""
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera
    from direct12pbrrenderer_tpu_torch.tools.stress_scene import build_stress_scene

    scene = build_stress_scene(cells_x=24, cells_y=12, n_lights=4)
    for sm in scene.models:
        for mat in sm.model.materials:
            mat.set_parameter("UseAlbedoMap", albedo)
    cfg = RenderConfig(width=128, height=96, max_instances=2, max_lights=8)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([3.0, 4.0, 9.0])
    cam.rotate(0.0, np.pi * 0.9, 0.28)
    return scene, cfg, cam


@pytest.mark.parametrize("albedo", [False, True])
def test_auto_caps_frame_sized_once_and_gate_clean(albedo):
    """The gate of test_auto_caps.py on its scene, and with the albedo map
    on (the census then sizes caps from real page demand). No sky, as
    there: with `_pkg_scene`'s 16^2 noise sky the cache path of either
    package misses this bar against its own plain path at any caps, auto
    or not, which is not what this gate measures."""
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer_tpu_torch.tools import tap_census

    scene, cfg, cam = _gate_scene(albedo)
    pipe = DeferredRenderPipeline(scene, cfg, tex_caps="auto", use_tex_kernel=True,
                                  device="cpu", **KNOBS)
    calls = []
    real = tap_census.run_census

    def counted(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    pose = copy.deepcopy(cam)
    with mock.patch.object(tap_census, "run_census", counted):
        a = pipe.render(cam).numpy()
        assert calls == [dict(poses=3, yaw_sweep_deg=30.0)]
        assert np.array_equal(cam.view_matrix(), pose.view_matrix())   # a copy was probed
        cap_lo, cap_hi, budget, block_caps = pipe.tex_caps
        assert (cap_lo + texcache.CAP_FB) % texcache.SEG_CHUNK == 0 and budget > 0
        assert isinstance(block_caps, tuple) and len(block_caps) == 2
        assert pipe.tex_cascade == (12, 8, 1) and pipe.env_budget is not None
        assert (cap_lo > 4) == albedo                 # the census saw the map's pages
        a2 = pipe.render(cam).numpy()                 # sized once: no second census
        assert len(calls) == 1 and a2.shape == a.shape == (cfg.height, cfg.width, 3)
        seq = pipe.render_sequence([cam, cam])
        assert len(calls) == 1 and tuple(seq.shape) == (2, cfg.height, cfg.width, 3)

    ref = DeferredRenderPipeline(scene, cfg, use_tex_kernel=False, use_pallas=False,
                                 device="cpu", **KNOBS)
    pipe.avg_luminance = torch.zeros(())
    a = pipe.render(cam).numpy().astype(np.float64)
    b = ref.render(cam).numpy().astype(np.float64)
    rmse = math.sqrt(np.mean((a / 255.0 - b / 255.0) ** 2))
    assert rmse <= 1e-3, rmse

    # render_sequence sizes a fresh pipeline at its first camera, as render does
    fresh = DeferredRenderPipeline(scene, cfg, tex_caps="auto", use_tex_kernel=True,
                                   device="cpu", **KNOBS)
    fresh.render_sequence([cam])
    assert fresh.tex_caps == pipe.tex_caps and fresh.env_budget == pipe.env_budget
