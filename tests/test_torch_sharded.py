"""The port's row-band frame (`parallel/frame_sharded.py`) against the JAX
package, on gloo ranks with `device="cpu"` (the kernels' plain versions on
the band path), the inputs made with numpy from fixed seeds.

* The JAX `test_sharded_pad_to_tile_bands` setup (128x120, tile 12x64, 30-row
  bands on 36-row canvases) against JAX `build_sharded_frame` on 4 virtual
  devices, both from the JAX pipeline's buffers: the frame within rmse 1e-3
  on uint8/255 with fewer than 1e-3 of the pixels off by more than 1, the
  exposure within rtol 1e-5, and the `collect_stats` outputs equal.
* The fused path on 2 ranks against the JAX single-chip fused frame (kernels
  in interpret mode) and the port's own single-device frame, at those bars.
* A light-tile frame whose light cap truncates: its `light_trunc` against
  JAX `lights_pallas.tile_light_lists` at each band's offset.
* Function-level checks at a band offset of a taller frame (binning, the
  interpolated planes, the fused deferred pass, the unfused deferred pass
  with the tiled lights, the camera rays), each at its module's bar.
* The band bloom against `bloom(hdr)` (max abs within 1e-5 of max |bloom|:
  the row products are blocked differently) and the band exposure bit-equal
  to `average_luminance_direct`.
* `dryrun_multichip(2, device="cpu")`, and the raises without a card.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from direct12pbrrenderer_tpu.config import RenderConfig
from direct12pbrrenderer_tpu.ops import clustered as jcl
from direct12pbrrenderer_tpu.ops import common as jc
from direct12pbrrenderer_tpu.ops import ibl as jibl
from direct12pbrrenderer_tpu.ops import lights_pallas
from direct12pbrrenderer_tpu.ops import raster as jr
from direct12pbrrenderer_tpu.ops import raster_pallas as jrp
from direct12pbrrenderer_tpu.ops import shade_pallas
from direct12pbrrenderer_tpu.ops import shading as jsh
from direct12pbrrenderer_tpu.parallel import frame_sharded as jfs
from direct12pbrrenderer_tpu.pipeline import stages as jstages
from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JaxPipeline
from direct12pbrrenderer_tpu.scene.camera import Camera
from direct12pbrrenderer_tpu.tools.stress_scene import build_stress_scene
from direct12pbrrenderer_tpu_torch.ops import bloom as tbloom
from direct12pbrrenderer_tpu_torch.ops import common as tc
from direct12pbrrenderer_tpu_torch.ops import postprocess, shade_fused
from direct12pbrrenderer_tpu_torch.ops import raster as tr
from direct12pbrrenderer_tpu_torch.ops import raster_cuda as trc
from direct12pbrrenderer_tpu_torch.ops import shading as tsh
from direct12pbrrenderer_tpu_torch.parallel import frame_sharded
from direct12pbrrenderer_tpu_torch.pipeline import stages as tstages
from direct12pbrrenderer_tpu_torch.tools.tiny_scene import dryrun_multichip
from test_pipeline import build_scene
from test_sharded import _sharded_args
from test_torch_pipeline import _fused_scene, _rmse, jax_state
from test_torch_lights import _assert_rgb_close
from test_torch_raster import _check_fold, _setups
from test_torch_shade_fused import _inputs as _fused_inputs
from test_raster_pallas import _rows64
from torch_band_ranks import band_frame, post_chain

torch.set_num_threads(2)
RMSE_BAR = 1e-3


def _camera(cfg, pos=(0, 0, 4), pitch=0.0):
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move(list(pos))
    cam.rotate(0, math.pi, pitch)
    return cam


def _assert_frame_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    assert _rmse(got, want) <= RMSE_BAR
    assert (np.abs(got.astype(int) - want.astype(int)) > 1).mean() < 1e-3


def test_pad_to_tile_bands_match_jax_sharded_frame():
    """128x120 on 4 ranks: 30-row bands on 36-row canvases (tile 12x64)."""
    cfg = RenderConfig(width=128, height=120, max_triangles=2048, max_vertices=2048,
                       max_instances=4, max_lights=16)
    knobs = dict(tile_h=12, tile_w=64, bin_cap=512, prefilter_size=16, brdf_lut_size=32)
    jp = JaxPipeline(build_scene(), cfg, **knobs)
    cam = _camera(cfg)
    assert len(jax.devices()) >= 4
    want = jfs.build_sharded_frame(jfs.make_mesh(4), jp, collect_stats=True)(
        *_sharded_args(jp, cam))
    rgb8, avg, bin_counts, tex_approx, light_trunc, env_approx = (np.asarray(x) for x in want)
    res = frame_sharded.launch(4, band_frame, jp.scene, cfg, knobs, jax_state(jp), cam,
                               device="cpu")
    got = res[0]
    assert (rgb8.max(-1) > 16).mean() > 0.05
    for r in res:   # every rank holds the same gathered frame and reductions
        np.testing.assert_array_equal(r["frame"], got["frame"])
        assert (r["avg"], r["tex_approx"], r["light_trunc"]) == (
            got["avg"], got["tex_approx"], got["light_trunc"])
    np.testing.assert_array_equal(np.concatenate([r["band"] for r in res]), got["frame"])
    _assert_frame_close(got["frame"], rgb8)
    np.testing.assert_allclose(got["avg"], float(avg), rtol=1e-5)
    assert got["bin_counts"].shape == ((36 // 12) * (128 // 64) * 4,)
    np.testing.assert_array_equal(got["bin_counts"], bin_counts)
    assert (got["tex_approx"], got["light_trunc"], got["env_approx"]) == (
        int(tex_approx), int(light_trunc), int(env_approx))


def test_fused_band_frame_matches_jax_single_chip_frame():
    """The fused path (kernels A-D's plain versions) in 48-row bands at
    y_offset 0 and 48, against the JAX fused frame (interpret mode)."""
    scene, cam, _ = _fused_scene(True)
    cfg = RenderConfig(width=128, height=96, max_triangles=2048, max_vertices=2048,
                       max_instances=4, max_lights=16)
    knobs = dict(tile_h=24, tile_w=128, bin_cap=512, prefilter_size=16, brdf_lut_size=32,
                 use_pallas=True, use_tex_kernel=True)
    jp = JaxPipeline(scene, cfg, pallas_interpret=True, **knobs)
    cam = _camera(cfg)
    state = jax_state(jp)   # before the frame: the exposure carry is 0 in both
    want = np.asarray(jp.render(cam))
    res = frame_sharded.launch(2, band_frame, scene, cfg, knobs, state, cam, True,
                               device="cpu")
    got = res[0]
    assert got["paths"] == (True, True, None)   # fused G-buffer and deferred pass
    assert (want.max(-1) > 16).mean() > 0.05
    _assert_frame_close(got["frame"], want)
    _assert_frame_close(got["frame"], got["single"])
    np.testing.assert_allclose(got["avg"], float(jp.avg_luminance), rtol=1e-5)
    np.testing.assert_allclose(got["avg"], got["single_avg"], rtol=1e-5)
    assert jp.last_stats.tex_approx_taps == got["tex_approx"] == 0
    assert jp.last_stats.env_approx_taps == got["env_approx"]


def test_light_tile_truncation_matches_jax_tile_lists():
    """448 lights (352 visible) and a light cap of 128 on the light-tile
    path (kernels A, B, C, F, G's plain versions), 48-row bands: the top
    band's tiles list about 180 lights, the bottom band's about 100, and the
    truncation is that of JAX tile_light_lists at the bands' offsets."""
    scene = build_stress_scene(cells_x=16, cells_y=8, n_lights=448)
    cfg = RenderConfig(width=256, height=96, max_instances=2, max_lights=448,
                       max_triangles=2048, max_vertices=2048)
    knobs = dict(tile_h=24, tile_w=128, bin_cap=256, max_active_lights=512, light_cap=128,
                 atlas_max_dim=64, prefilter_size=16, brdf_lut_size=32, use_pallas=True,
                 use_tex_kernel=True)
    jp = JaxPipeline(scene, cfg, pallas_interpret=True, **knobs)
    cam = _camera(cfg, (0, 4, 10), 0.3)
    args = _sharded_args(jp, cam)
    light_bounds, planes, view = args[4], args[5], args[6]
    valid = jc.frustum_cull_aabbs(planes, light_bounds[:, 0], light_bounds[:, 1]) & (
        jnp.arange(light_bounds.shape[0]) < jp.packed.light_count)
    active = jstages.active_lights(jp.buffers, valid, view, 512)
    want = 0
    for y0 in (0, 48):
        _, counts = lights_pallas.tile_light_lists(
            active, 2, 2, 24, 128, 256, 96, cfg.fov, cfg.ratio, cfg.near, cfg.far, 128,
            y_offset=float(y0))
        want = max(want, int(jnp.maximum(np.asarray(counts) - 128, 0).max()))
    assert want > 0
    res = frame_sharded.launch(2, band_frame, scene, cfg, knobs, jax_state(jp), cam,
                               device="cpu")
    got = res[0]
    assert got["paths"] == (True, False, (24, 128))
    assert got["light_trunc"] == res[1]["light_trunc"] == want
    assert np.isfinite(got["frame"]).all() and (got["frame"].max(-1) > 16).mean() > 0.05


# ---- function-level checks at a band offset of a taller frame --------------

W, H, TH, TW = 256, 192, 24, 128
Y0, BAND = 96, 96    # the second of two 96-row bands of the 192-row frame


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def setups():
    return _setups(2500, 3)


@pytest.mark.parametrize("kind", ["flat", "hier"])
def test_binning_at_band_offset_bit_equal(setups, kind):
    js, ts, _ = setups
    if kind == "flat":
        jb = jstages.binning(js, W, BAND, TH, TW, 128, y_offset=Y0)
        tb = tstages.binning(ts, W, BAND, TH, TW, 128, y_offset=Y0)
    else:
        args = (BAND // TH, W // TW, TH, TW, 128)
        jb = jr.bin_triangles_hier(js, *args, y_offset=Y0, cap1=300)
        tb = tr.bin_triangles_hier(ts, *args, y_offset=Y0, cap1=300)
    assert int(np.asarray(jb.counts).sum()) > 0
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))


def test_interpolated_planes_at_band_offset(setups):
    js, ts, _ = setups
    jb = jr.bin_triangles(js, BAND // TH, W // TW, TH, TW, 512, y_offset=Y0)
    tb = tr.Bins(_t(jb.ids), _t(jb.counts))
    rows64 = _rows64(js, 2500, 3)
    ids_j, z_j, pl_j = jrp.rasterize_interp_pallas(js, jb, rows64, W, BAND, TH, TW,
                                                   y_offset=Y0, interpret=True)
    ids_t, z_t, pl_t = trc.rasterize_interp(ts, tb, _t(rows64), W, BAND, TH, TW, y_offset=Y0)
    agree = _check_fold(ids_t, z_t, ids_j, z_j)
    pl_t, pl_j = pl_t.numpy(), np.asarray(pl_j)
    np.testing.assert_array_equal(pl_t[8:, agree], pl_j[8:, agree])
    np.testing.assert_allclose(pl_t[:8, agree], pl_j[:8, agree], rtol=1e-3, atol=1e-4)
    # the band's rows are the full frame's rows Y0.. (the same fold at y_offset 0)
    jb0 = jr.bin_triangles(js, H // TH, W // TW, TH, TW, 512)
    ids_f, _, _ = trc.rasterize_interp(ts, tr.Bins(_t(jb0.ids), _t(jb0.counts)), _t(rows64),
                                       W, H, TH, TW)
    np.testing.assert_array_equal(ids_t.numpy(), ids_f.numpy()[Y0:])


def test_fused_deferred_pass_at_band_offset():
    """Plain kernel D's pass on 48-row tile blocks as the second band of a
    96-row frame (the shade_fused test's bar)."""
    d = _fused_inputs(5, True)
    cfg = d["cfg"]
    h, w = d["bg"].shape
    common = (d["env_ids"], cfg.fov, cfg.ratio, cfg.near, cfg.far, w, h, 24, 128)
    band = dict(y_offset=h, full_height=2 * h, full_width=w)
    want_rt, want_approx = shade_pallas.deferred_shade_fused(
        *(jnp.asarray(d[k]) for k in ("gb_tiles", "z_tiles", "id_tiles", "sh_pack")),
        d["atlases"][0].build(), jnp.asarray(d["active"]), jnp.asarray(d["inv_view"]),
        jnp.asarray(d["cam_pos"]), *common, interpret=True, **band)
    got_rt, got_approx = shade_fused.deferred_shade_fused(
        *(torch.as_tensor(d[k]) for k in ("gb_tiles", "z_tiles", "id_tiles", "sh_pack")),
        d["atlases"][1].build("cpu"), torch.as_tensor(d["active"]),
        torch.as_tensor(d["inv_view"]), torch.as_tensor(d["cam_pos"]), *common, **band)
    a, b = np.asarray(want_rt), got_rt.numpy()
    assert np.isfinite(b).all() and b[~d["bg"]].max() > 0.05
    bad = ~np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 1e-3, (bad.sum(), np.abs(a - b).max())
    assert int(got_approx) == int(want_approx)
    # the offset moves the shading: the same blocks at y_offset 0 differ
    top = shade_fused.deferred_shade_fused(
        *(torch.as_tensor(d[k]) for k in ("gb_tiles", "z_tiles", "id_tiles", "sh_pack")),
        d["atlases"][1].build("cpu"), torch.as_tensor(d["active"]),
        torch.as_tensor(d["inv_view"]), torch.as_tensor(d["cam_pos"]), *common,
        full_height=2 * h, full_width=w)[0].numpy()
    assert np.abs(top - b).max() > 1e-3


def _deferred_inputs():
    """A 48x128 band of a 96x128 frame: quantized G-buffer planes, env
    mips, a sky and 24 lights in front of the camera."""
    rng = np.random.default_rng(11)
    h, w = 48, 128
    q = lambda x: (np.round(x * 255) / 255).astype(np.float32)  # noqa: E731
    planes = (q(rng.uniform(0, 1, (h, w, 4))), q(rng.uniform(0, 1, (h, w, 2))),
              q(rng.uniform(0, 1, (h, w, 3))),
              rng.uniform(0.95, 0.9999, (h, w)).astype(np.float32),
              rng.uniform(size=(h, w)) < 0.8,
              rng.normal(0, 0.3, (7, 4)).astype(np.float32))
    lut = np.asarray(jibl.brdf_lut(size=16))
    pf = [rng.uniform(0, 3, (6, 16 >> m, 16 >> m, 3)).astype(np.float32) for m in range(5)]
    sky = rng.uniform(0, 3, (6, 8, 8, 3)).astype(np.float32)
    cam = Camera(1.0, w, 2 * h, 0.1, 100.0)
    cam.move([0.5, 1.0, 6.0])
    cam.rotate(0, np.pi, 0.1)
    view = cam.view_matrix().astype(np.float32)
    inv_view = cam.world_matrix().astype(np.float32)
    n = 24
    local = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(-8, -2, n), np.ones(n)], -1).astype(np.float32)
    pos = (local @ inv_view.T)[:, :3].astype(np.float32)
    lights = np.asarray(jcl.build_active_lights(
        jnp.asarray(pos), jnp.asarray(rng.uniform(0.2, 1, (n, 3)).astype(np.float32)),
        jnp.asarray(rng.uniform(5, 30, n).astype(np.float32)),
        jnp.asarray(np.tile(np.float32([[3.0, 1.0, 0.09, 0.032]]), (n, 1))),
        jnp.ones((n,), bool), jnp.asarray(view), 32))
    return planes, lut, pf, sky, lights, inv_view, np.asarray(cam.position, np.float32)


def test_tiled_lights_deferred_pass_at_band_offset():
    """The unfused deferred pass with the tiled lights (kernel G's plain
    version) on the second 48-row band of a 96-row frame, against the JAX
    pass with the TPU kernel in interpret mode (test_torch_lights' bar)."""
    planes, lut, pf, sky, lights, inv_view, pos = _deferred_inputs()
    h, w = planes[3].shape
    scal = (1.0, w / (2 * h), 0.1, 100.0)
    band = dict(y_offset=h, full_height=2 * h, full_width=w, light_tile=(24, 128),
                light_cap=128)
    j = jsh.deferred_shade(
        *(jnp.asarray(a) for a in planes), (jc.make_quad_tex2d(jnp.asarray(lut)), 16),
        jc.CubeMipAtlas([jnp.asarray(m) for m in pf]), jc.CubeMipAtlas([jnp.asarray(sky)]),
        jnp.asarray(lights), jnp.asarray(inv_view), jnp.asarray(pos), *scal, w, h,
        env_interpret=True, **band)
    t, counts = tsh.deferred_shade(
        *(_t(a) for a in planes), (tc.make_quad_tex2d(_t(lut)), 16),
        tc.CubeMipAtlas.from_mips(pf, "cpu"), tc.CubeMipAtlas.from_mips([sky], "cpu"),
        _t(lights), _t(inv_view), _t(pos), *scal, w, h, return_light_counts=True, **band)
    _, want_counts = lights_pallas.tile_light_lists(
        jnp.asarray(lights), 2, 1, 24, 128, w, 2 * h, *scal, 128, y_offset=float(h))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert int(counts.sum()) > 0
    _assert_rgb_close(t.numpy(), np.asarray(j))


def test_camera_rays_at_band_offset():
    cam = Camera(1.0, W, H, 0.1, 100.0)
    cam.rotate(0.2, 2.5, 0.3)
    inv_view = cam.world_matrix().astype(np.float32)
    args = (W, BAND, None, 1.0, W / H, 0.1)
    j = jsh.camera_rays(*args[:2], jnp.asarray(inv_view), *args[3:], y_offset=Y0,
                        full_height=H, full_width=W)
    t = tsh.camera_rays(*args[:2], _t(inv_view), *args[3:], y_offset=Y0, full_height=H,
                        full_width=W)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    full = tsh.camera_rays(W, H, _t(inv_view), 1.0, W / H, 0.1)
    np.testing.assert_array_equal(t.numpy(), full.numpy()[Y0:])


# ---- the post chain across bands --------------------------------------------

POST_SHAPES = [(256, 96), (280, 72)]   # 280 / 4: 35 rows, then 17 (uneven split)


@pytest.fixture(scope="module")
def post_chain_run():
    rng = np.random.default_rng(21)
    hdrs = []
    for h, w in POST_SHAPES:
        hdr = (rng.uniform(0, 1, (h, w, 3)) ** 4 * 6).astype(np.float32)
        hdr[:5] = 0.0          # black pixels: bin 0
        hdrs.append(hdr)
    return hdrs, frame_sharded.launch(4, post_chain, hdrs, device="cpu")


@pytest.mark.parametrize("shape", range(len(POST_SHAPES)))
def test_band_bloom_matches_bloom(post_chain_run, shape):
    hdrs, res = post_chain_run
    hdr = hdrs[shape]
    want = tbloom.bloom(torch.as_tensor(hdr)).numpy()
    got = np.concatenate([r[shape][0] for r in res])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


class _OneRank:
    rank, size = 0, 1

    def all_reduce(self, t):
        return t


@pytest.mark.parametrize("hw", [(96, 64), (37, 53), (135, 240)])
def test_one_band_bloom_is_bloom_bit_for_bit(hw):
    """A one-rank group (the one-card NCCL run) takes every level whole: the
    band form is then bloom(hdr)'s own products, bit for bit."""
    hdr = torch.as_tensor((np.random.default_rng(5).uniform(0, 1, hw + (3,)) ** 4 * 6)
                          .astype(np.float32))
    assert torch.equal(tbloom.bloom_band(hdr, hw[0], _OneRank()), tbloom.bloom(hdr))


@pytest.mark.parametrize("shape", range(len(POST_SHAPES)))
def test_band_exposure_bit_equal(post_chain_run, shape):
    hdrs, res = post_chain_run
    hdr = torch.as_tensor(hdrs[shape])
    want = postprocess.average_luminance_direct(hdr, float(hdr.shape[0] * hdr.shape[1]),
                                                torch.tensor(0.3), 1.0 / 60.0)
    for r in res:
        assert r[shape][1].tobytes() == want.numpy().tobytes()


def test_dryrun_multichip_on_cpu(capsys):
    dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "dryrun_multichip(2): backend gloo on cpu"
    assert out[-1].startswith("dryrun_multichip(2): frame (64, 128, 3) ok")


def test_no_card_raises_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frame_sharded.launch(2, post_chain, [])
    with pytest.raises(RuntimeError, match="process group"):
        frame_sharded.make_mesh()
    store = dist.FileStore(os.path.join(tmp_path, "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            frame_sharded.make_mesh()
        mesh = frame_sharded.make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
        assert frame_sharded.backend_for(2, "cpu") == "gloo"
        assert frame_sharded.backend_for(1, "cuda:0") == "gloo"
    finally:
        dist.destroy_process_group()
