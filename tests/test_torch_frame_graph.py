"""The port's frame without host reads, on the CPU: the counterpart of the
JAX pipeline's `jax.jit(_frame)` and `render_sequence` (its `lax.scan`).

* `render_sequence` against the JAX package's over three poses of the
  default path (the fused G-buffer and deferred pass, 256x96, tile 24x128,
  the JAX pipeline's buffers loaded): every frame within the JAX package's
  fidelity bar, rmse <= 1e-3 on uint8/255, the exposure carry within rtol
  1e-5, and equal FrameStats on the frame that follows (the bars of
  tests/test_torch_pipeline.py's default-path frame).
* `raster.bin_triangles_hier`, whose fine pass no longer asks the host how
  wide to run, bit for bit against the JAX package's (its `lax.cond`) on a
  pool whose supertiles all hold at most cap1 // 4 candidates and on one
  whose supertiles hold more (some more than cap1).
* Bloom with its matrices cached on the device against the JAX package's
  `ops/bloom.bloom` (rtol 1e-5 / atol 1e-5, tests/test_torch_gbuffer_shading.py's
  bar), the second call making no host-to-device copy.
* A guard (`tests/torch_host_reads.py`'s `no_host_reads`) that fails the
  test on any host read of a tensor or tensor made from host data while
  `_frame` runs at the default path's knobs and on every other single-card
  path (PATHS: the 1024-light path, planar-tex, anisotropic,
  `use_tex_kernel=False`, all-plain; on the sky scene at 256x96), or the
  hierarchical binning, outside the kernels' plain versions. On a card
  these are the syncs and pageable copies a CUDA graph capture refuses;
  `tests/test_torch_frame_graph_cuda.py` holds the captured frames there.
* The glue that a frame once read back or uploaded, each bit for bit
  against what it computed before: the dense light sweep at its static
  bound against the same sweep over the live rows only (also with a
  visible light of zero radius among them, where the JAX sweep's trip
  count leaves the last live row out) and against the JAX `deferred_shade`
  (tests/test_torch_gbuffer_shading.py's bar); the cube-atlas fetch at an
  int mip against a 0-d tensor mip; kernel G's constants from the device
  cache against ones built afresh, over two fovs and two band offsets; the
  plain raster fold over every chunk of the lists' capacity against a fold
  of only the used chunks and one stopped at the fullest list (as the
  kernels' plain versions stop it).
* `render_sequence` on the 1024-light and planar-tex paths against the JAX
  package's (its `lax.scan`), at the default path's bars.
"""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_triangles
from direct12pbrrenderer_tpu.ops import bloom as jbloom
from direct12pbrrenderer_tpu.ops import clustered as jcl
from direct12pbrrenderer_tpu.ops import common as jc
from direct12pbrrenderer_tpu.ops import ibl as jibl
from direct12pbrrenderer_tpu.ops import raster as jraster
from direct12pbrrenderer_tpu.ops import shading as jsh
from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JaxPipeline
from direct12pbrrenderer_tpu_torch.ops import bloom, common, lights_cuda, raster, shading
from direct12pbrrenderer_tpu_torch.pipeline import stages
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.state import state_from_jax
from direct12pbrrenderer_tpu_torch.tools.tiny_scene import tiny_pipeline
from test_torch_gbuffer_shading import _camera, _lights
from test_torch_pipeline import FUSED_KNOBS, RMSE_BAR, _fused_scene, _poses, _rmse, jax_state
from torch_host_reads import no_host_reads

torch.set_num_threads(2)

# every single-card path besides the default one: its knobs over
# FUSED_KNOBS (tile 24x128, bin_cap 512) on the sky scene at 256x96
PATHS = {
    # more than 64 active lights: light_tile, kernels A, B, C, F, G
    "lights1k": dict(use_pallas=True, use_tex_kernel=True, max_active_lights=128),
    # a raster tile not 128 wide: kernel A's planes, the planar cache (B, E), F
    "planar-tex": dict(use_pallas=True, use_tex_kernel=True, tile_w=160),
    "anisotropic": dict(use_pallas=True, use_tex_kernel=True, texture_filter="anisotropic"),
    # kernel A, the direct-atlas sampler, the dense light sweep
    "use_tex_kernel=False": dict(use_pallas=True, use_tex_kernel=False),
    # the plain fold, the row gather, the direct-atlas sampler, the dense sweep
    "all-plain": dict(use_pallas=False, use_tex_kernel=False),
}


@pytest.mark.parametrize("probe", [
    lambda: torch.ones(3).sum().item(), lambda: bool(torch.ones(1) > 0),
    lambda: torch.arange(4)[torch.arange(4) > 1], lambda: torch.tensor([1.0, 2.0]),
    lambda: int(torch.ones(())), lambda: torch.ones(2).tolist(),
    lambda: torch.bincount(torch.arange(3))])
def test_guard_catches_host_reads(probe):
    with pytest.raises(AssertionError), no_host_reads():
        probe()
    probe()   # and lets them through again


@pytest.mark.parametrize("light_dtype", [None, "bfloat16"])
def test_default_frame_makes_no_host_read(light_dtype):
    pipe, cam, _ = tiny_pipeline("cpu", width=256, height=96, tile_h=24, tile_w=128,
                                 use_pallas=True, use_tex_kernel=True,
                                 fused_light_dtype=light_dtype)
    assert pipe.use_fused_gbuffer and pipe.use_fused_deferred and not pipe.captured
    pipe.render(cam)   # fills the device constants' caches, as a capture's warm-up does
    pipe._upload(cam, 1.0 / 60.0)
    args = (pipe._scene_dev, pipe._cam_dev, pipe.avg_luminance)
    want = pipe._frame(*args)
    with no_host_reads():
        got = pipe._frame(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@functools.cache
def _sky_scene():
    return _fused_scene(True)


def _path_pipeline(path: str):
    scene, cam, cfg = _sky_scene()
    pipe = DeferredRenderPipeline(scene, cfg, device="cpu", **dict(FUSED_KNOBS, **PATHS[path]))
    flags = (pipe.light_tile is not None, pipe.use_fused_gbuffer, pipe.use_fused_deferred,
             pipe.use_tex_kernel, pipe.use_pallas)
    assert flags == {"lights1k": (True, True, False, True, True),
                     "planar-tex": (False, False, False, True, True),
                     "anisotropic": (False, False, False, True, True),
                     "use_tex_kernel=False": (False, False, False, False, True),
                     "all-plain": (False, False, False, False, False)}[path]
    return pipe, cam


@pytest.mark.parametrize("path", list(PATHS))
def test_path_frame_makes_no_host_read(path):
    pipe, cam = _path_pipeline(path)
    assert not pipe.captured
    pipe.render(cam)   # fills the device constants' caches, as a capture's warm-up does
    pipe._upload(cam, 1.0 / 60.0)
    args = (pipe._scene_dev, pipe._cam_dev, pipe.avg_luminance)
    want = pipe._frame(*args)
    with no_host_reads():
        got = pipe._frame(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (want[0].max(-1).values > 16).float().mean() > 0.05   # a non-trivial frame


def _shade_inputs(dark_row: bool):
    """tests/test_torch_gbuffer_shading.py's deferred-pass inputs, numpy: 12
    scene lights (about 70% visible) compacted into 16 active rows; with
    `dark_row` the second visible light has zero intensity, so zero cull
    radius, among the live rows."""
    rng = np.random.default_rng(4)
    h, w = 32, 48
    q = lambda x: (np.round(x * 255) / 255).astype(np.float32)  # noqa: E731
    planes = [q(rng.uniform(0, 1, (h, w, c))) for c in (4, 2, 3)]
    depth = rng.uniform(0.95, 0.9999, (h, w)).astype(np.float32)
    mask = rng.uniform(size=(h, w)) < 0.8
    sh = rng.normal(0, 0.3, (7, 4)).astype(np.float32)
    lut = np.asarray(jibl.brdf_lut(size=16))
    pf = [rng.uniform(0, 3, (6, 16 >> m, 16 >> m, 3)).astype(np.float32) for m in range(5)]
    sky = rng.uniform(0, 3, (6, 8, 8, 3)).astype(np.float32)
    cam = _camera()
    view = cam.view_matrix().astype(np.float32)
    pos, col, inten, att, valid = _lights(12, 5)
    if dark_row:
        inten = inten.copy()
        inten[np.flatnonzero(valid)[1]] = 0.0
    lights = np.asarray(jcl.build_active_lights(*(jnp.asarray(a) for a in (
        pos, col, inten, att, valid)), jnp.asarray(view), 16))
    return (planes, depth, mask, sh, lut, pf, sky, lights,
            cam.world_matrix().astype(np.float32), np.asarray(cam.position, np.float32),
            (1.0, w / h, 0.1, 100.0, w, h))


@pytest.mark.parametrize("dark_row", [False, True])
def test_dense_sweep_at_a_static_bound(dark_row):
    planes, depth, mask, sh, lut, pf, sky, lights, inv_view, pos, scal = _shade_inputs(dark_row)
    def t(x):
        return torch.as_tensor(np.array(x))

    pre = (*(t(a) for a in (*planes, depth, mask, sh)), (common.make_quad_tex2d(t(lut)), 16),
           common.CubeMipAtlas.from_mips(pf, "cpu"), common.CubeMipAtlas.from_mips([sky], "cpu"))
    n_active = int((lights[:, 13] > 0).sum())
    assert 0 < n_active < 12   # some scene lights culled: the bound is above the live rows
    if dark_row:   # the JAX trip count leaves the last live row out
        assert lights[n_active, 13] > 0 and (lights[:n_active, 13] == 0).sum() == 1
    rows, cam = t(lights), (t(inv_view), t(pos))

    def sweep(ids):   # the sweep over these rows alone, each with cull_r > 0
        return shading.deferred_shade(*pre, rows[ids], *cam, *scal)

    # the rows the JAX sweep walks, [0, n_active), but for a dark row, which
    # never hits
    walked = [i for i in range(n_active) if lights[i, 13] > 0]
    live = sweep(walked)   # (fills the device fov cache)
    with no_host_reads():
        got = shading.deferred_shade(*pre, rows, *cam, *scal, light_count=12)
    assert torch.equal(got, live) and not torch.equal(got, sweep([]))
    if dark_row:
        assert not torch.equal(got, sweep(walked + [n_active]))
    want = np.asarray(jsh.deferred_shade(
        *(jnp.asarray(a) for a in (*planes, depth, mask, sh)),
        (jc.make_quad_tex2d(jnp.asarray(lut)), 16),
        jc.CubeMipAtlas([jnp.asarray(m) for m in pf]), jc.CubeMipAtlas([jnp.asarray(sky)]),
        jnp.asarray(lights), jnp.asarray(inv_view), jnp.asarray(pos), *scal))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert np.isclose(got.numpy(), want, rtol=1e-5, atol=1e-6).mean() > 0.99


def test_cube_atlas_fetch_at_an_int_mip():
    rng = np.random.default_rng(5)
    mips = [rng.uniform(0, 3, (6, 16 >> m, 16 >> m, 3)).astype(np.float32) for m in range(3)]
    atlas = common.CubeMipAtlas.from_mips(mips, "cpu")
    dirs = torch.as_tensor(rng.normal(size=(40, 24, 3)).astype(np.float32))
    for mip in range(3):
        with no_host_reads():
            got = common._cube_atlas_bilinear(atlas, dirs, mip)
        assert torch.equal(got, common._cube_atlas_bilinear(atlas, dirs, torch.tensor(mip)))


def _fresh_light_constants(inv_view, camera_pos, fov, ratio, near, far, fw, fh, y_offset):
    """Kernel G's const vector built afresh on every call, as before the
    device cache."""
    f32 = dict(dtype=torch.float32)
    return torch.cat([
        torch.tensor([math.tan(fov / 2.0), ratio, near, far], **f32),
        camera_pos.float().reshape(3), torch.tensor([y_offset], **f32),
        inv_view[:3, :3].reshape(9).float(),
        torch.tensor([fw, fh, math.log(far / near), far / near], **f32), torch.zeros(11, **f32)])


@pytest.mark.parametrize("fov", [1.0, math.pi / 3])
@pytest.mark.parametrize("y_offset", [0, 540])
def test_light_constants_from_the_device_cache(fov, y_offset):
    cam = _camera()
    inv_view = torch.as_tensor(cam.world_matrix().astype(np.float32))
    pos = torch.as_tensor(np.asarray(cam.position, np.float32))
    args = (fov, 1920 / 1080, 0.1, 100.0, 1920, 1080, y_offset)
    first = lights_cuda.light_constants(inv_view, pos, *args)
    with no_host_reads():
        got = lights_cuda.light_constants(inv_view, pos, *args)
    want = _fresh_light_constants(inv_view, pos, *args)
    assert torch.equal(got, want) and torch.equal(first, want)


def test_plain_fold_at_the_static_bound():
    w, h, th, tw, cap = 256, 192, 24, 128, 512
    clip, tris, _ = random_triangles(2500, 3, "cpu")
    setup = raster.setup_triangles(clip, tris, torch.ones(tris.shape[0], dtype=torch.bool), w, h)
    bins = raster.bin_triangles(setup, h // th, w // tw, th, tw, cap)
    used = -(-int(bins.counts.max()) // 64) * 64
    assert 64 < used < cap   # chunks past the fullest list, and more than one used
    with no_host_reads():
        got = raster.rasterize(setup, bins, w, h, th, tw)
    want = raster.rasterize(setup, raster.Bins(bins.ids[:, :used].contiguous(), bins.counts),
                            w, h, th, tw)
    stopped = raster.rasterize(setup, bins, w, h, th, tw, longest=int(bins.counts.max()))
    assert all(torch.equal(g, x) and torch.equal(g, y) for g, x, y in zip(got, want, stopped))
    assert (got[0] >= 0).float().mean() > 0.2


def _pool(t: int, width: int, height: int, seed: int, size: float, valid_frac: float):
    """(port setup, JAX setup, aabb, valid) of `t` random screen AABBs up to
    `size` pixels wide, a `valid_frac` share of them valid."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(-20, width, t), rng.uniform(-20, height, t)
    x1, y1 = x0 + rng.uniform(1, size, t), y0 + rng.uniform(1, size, t)
    aabb = np.stack([np.clip(np.floor(x0), 0, width), np.clip(np.floor(y0), 0, height),
                     np.clip(np.ceil(x1), 0, width), np.clip(np.ceil(y1), 0, height)],
                    1).astype(np.float32)
    valid = ((rng.uniform(size=t) < valid_frac) & (aabb[:, 2] > aabb[:, 0])
             & (aabb[:, 3] > aabb[:, 1]))
    zeros = {"xy": (t, 3, 2), "z": (t, 3), "w_clip": (t, 3), "edges": (t, 3, 3)}
    ts = raster.TriangleSetup(**{k: torch.zeros(v) for k, v in zeros.items()},
                              aabb=torch.as_tensor(aabb), valid=torch.as_tensor(valid))
    js = jraster.TriangleSetup(**{k: jnp.zeros(v) for k, v in zeros.items()},
                               aabb=jnp.asarray(aabb), valid=jnp.asarray(valid))
    return ts, js, aabb, valid


def _supertile_counts(aabb, valid, tiles_y, tiles_x, tile_h, tile_w, y_offset):
    """Each (8 x 4)-tile supertile's overlap count, in numpy."""
    out = []
    for sy in range(-(-tiles_y // 8)):
        for sx in range(-(-tiles_x // 4)):
            x0, y0 = sx * 4 * tile_w, sy * 8 * tile_h + y_offset
            out.append(int((valid & (aabb[:, 0] < x0 + 4 * tile_w) & (aabb[:, 2] > x0)
                            & (aabb[:, 1] < y0 + 8 * tile_h) & (aabb[:, 3] > y0)).sum()))
    return np.array(out)


# (triangles, tiles_y, tiles_x, tile_h, tile_w, cap, cap1, size, valid share, y_offset)
HIER_POOLS = {
    # every supertile within cap1 // 4: JAX's narrow fine pass
    "sparse": (16384, 9, 8, 24, 128, 512, 4096, 60, 0.1, 0),
    # supertiles above cap1 // 4, some above cap1 (their tiles' counts read
    # cap + 1): JAX's full-width fine pass
    "dense": (20000, 10, 9, 12, 64, 256, 4096, 300, 1.0, 36),
}


@pytest.mark.parametrize("pool", sorted(HIER_POOLS))
def test_bin_triangles_hier_matches_jax(pool):
    t, ty, tx, th, tw, cap, cap1, size, frac, yoff = HIER_POOLS[pool]
    ts, js, aabb, valid = _pool(t, tx * tw, ty * th + yoff, 7 + t, size, frac)
    cnt1 = _supertile_counts(aabb, valid, ty, tx, th, tw, yoff)
    cap_small = max(cap, cap1 // 4)
    if pool == "sparse":
        assert 0 < cnt1.max() <= cap_small
    else:
        assert cnt1.max() > cap1 and cnt1.min() > cap_small
    want = jraster.bin_triangles_hier(js, ty, tx, th, tw, cap, y_offset=yoff, cap1=cap1)
    with no_host_reads():
        got = raster.bin_triangles_hier(ts, ty, tx, th, tw, cap, y_offset=yoff, cap1=cap1)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert (got.counts > cap).any() == (pool == "dense")


def test_binning_stage_takes_hier_without_host_reads():
    """The pipeline's binning stage at a pool of 16384 triangles and 64
    tiles (where it takes the hierarchical binning) reads nothing back."""
    ts, _, _, _ = _pool(16384, 8 * 128, 8 * 24, 3, 80, 1.0)
    want = raster.bin_triangles_hier(ts, 8, 8, 24, 128, 512, cap1=4096)
    with no_host_reads():
        got = stages.binning(ts, 8 * 128, 8 * 24, 24, 128, 512)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.counts, want.counts)


@pytest.mark.parametrize("hw", [(96, 256), (37, 53)])
def test_bloom_with_device_matrices_matches_jax(hw):
    rng = np.random.default_rng(11)
    hdr = (rng.uniform(0, 1, hw + (3,)) ** 4 * 6).astype(np.float32)
    x = torch.as_tensor(hdr)
    first = bloom.bloom(x)
    with no_host_reads():   # every matrix now comes from the cache
        got = bloom.bloom(x)
    assert torch.equal(got, first)
    np.testing.assert_allclose(got.numpy(), np.asarray(jbloom.bloom(jnp.asarray(hdr))),
                               rtol=1e-5, atol=1e-5)


def test_render_sequence_matches_jax_scan():
    scene, cam, cfg = _fused_scene(True)
    poses = _poses(cam, 4)
    jp = JaxPipeline(scene, cfg, use_pallas=True, use_tex_kernel=True, pallas_interpret=True,
                     **FUSED_KNOBS)
    state = jax_state(jp)
    want = np.asarray(jp.render_sequence(poses[:3]))
    want_avg = float(jp.avg_luminance)
    jp.render(poses[3])
    tp = DeferredRenderPipeline(scene, cfg, use_pallas=True, use_tex_kernel=True,
                                device="cpu", **FUSED_KNOBS)
    assert tp.use_fused_gbuffer and tp.use_fused_deferred
    tp.load_state(state_from_jax(state, "cpu"))
    got = tp.render_sequence(poses[:3]).numpy()
    assert got.shape == want.shape == (3, cfg.height, cfg.width, 3) and got.dtype == np.uint8
    for g, w in zip(got, want):
        assert (w.max(-1) > 16).mean() > 0.05   # a non-trivial frame
        assert _rmse(g, w) <= RMSE_BAR
    np.testing.assert_allclose(float(tp.avg_luminance), want_avg, rtol=1e-5)
    tp.render(poses[3])
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats)
    np.testing.assert_allclose(float(tp.avg_luminance), float(jp.avg_luminance), rtol=1e-5)


@pytest.mark.parametrize("path", ["lights1k", "planar-tex"])
def test_render_sequence_matches_jax_scan_on_path(path):
    scene, cam, cfg = _sky_scene()
    poses = _poses(cam, 4)
    knobs = dict(FUSED_KNOBS, **PATHS[path])
    jp = JaxPipeline(scene, cfg, pallas_interpret=True, **knobs)
    state = jax_state(jp)
    want = np.asarray(jp.render_sequence(poses[:3]))
    want_avg = float(jp.avg_luminance)
    jp.render(poses[3])
    tp, _ = _path_pipeline(path)
    assert (jp.light_tile, jp.use_fused_gbuffer, jp.use_tex_kernel) == (
        tp.light_tile, tp.use_fused_gbuffer, tp.use_tex_kernel)
    tp.load_state(state_from_jax(state, "cpu"))
    got = tp.render_sequence(poses[:3]).numpy()
    assert got.shape == want.shape == (3, cfg.height, cfg.width, 3) and got.dtype == np.uint8
    for g, w in zip(got, want):
        assert (w.max(-1) > 16).mean() > 0.05   # a non-trivial frame
        assert _rmse(g, w) <= RMSE_BAR
    np.testing.assert_allclose(float(tp.avg_luminance), want_avg, rtol=1e-5)
    tp.render(poses[3])
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats)
    np.testing.assert_allclose(float(tp.avg_luminance), float(jp.avg_luminance), rtol=1e-5)
