"""The port's frame held to the JAX package's ground truth, on the CPU.

* The float64 HLSL transcription (`tests/test_frame_transcription.py`): on
  its 64x48 scene, the port's frame with `use_pallas` False and True must
  lie within 1 LSB of the scalar frame on every pixel, at rmse <= 1.5e-3,
  with the exposure carry within 1e-3 relative. The scalar frame is built as
  that test builds it, with its float64 pieces (`gbuffer_ps`, `deferred_ps`,
  `np_bloom`, `np_exposure`, `np_tonemap`), from the port's own raster pick
  (`stages.geometry` / `binning` / `rasterize`) and the port's own
  precompute (SH, prefiltered mips, sky faces, BRDF LUT).
* The cache paths (the planar texture cache at tile 12x64 and the fused
  one at 24x128) miss that transcription in both packages (up to 37 LSB on
  25 pixels: the caches' counted fallback taps), so there the port's frame
  must equal the JAX frame (kernels in interpret mode) bit for bit, with
  equal FrameStats.
* The goldens (`tests/test_golden.py`): the port's sphere and emissive
  frames, same scenes, knobs, camera and two frames at delta_time 0.25,
  within 2e-3 of `tests/goldens/*.png` by the port's `compare_to_golden`.
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import test_frame_transcription as tx
from direct12pbrrenderer_tpu.config import CULLING_RADIUS_COEFFICIENT, RenderConfig
from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JaxPipeline
from direct12pbrrenderer_tpu.scene.camera import Camera
from direct12pbrrenderer_tpu.utils import fidelity as jax_fidelity
from direct12pbrrenderer_tpu_torch.ops import ibl
from direct12pbrrenderer_tpu_torch.pipeline import stages
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.utils import fidelity
from test_pipeline import build_scene

torch.set_num_threads(2)
W, H = tx.W, tx.H
TX_KNOBS = dict(tile_h=12, tile_w=64, bin_cap=512, prefilter_size=16, brdf_lut_size=16)
GOLDEN_DIR = Path(__file__).parent / "goldens"


def _tx_setup():
    cfg = RenderConfig(width=W, height=H, max_triangles=2048, max_vertices=2048,
                       max_instances=4, max_lights=4)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0.3, 0.6, 4.0])
    cam.rotate(0.0, math.pi, 0.08)
    return tx._scene(), cfg, cam


def _raster_pick(pipe, cam) -> np.ndarray:
    """The port's pixel -> triangle decision: its geometry, binning and plain
    fold, as the transcription test takes the JAX package's."""
    p = pipe.packed
    t = torch.as_tensor
    normal_mats = np.ascontiguousarray(np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1)))
    setup, _ = stages.geometry(
        pipe.buffers, t(p.model_mats), t(normal_mats),
        t(p.instance_visibility(cam.frustum_planes())),
        t(np.asarray(cam.projection_matrix() @ cam.view_matrix(), np.float32)), W, H)
    bins = stages.binning(setup, W, H, pipe.tile_h, pipe.tile_w, pipe.bin_cap)
    tri_id, _ = stages.rasterize(setup, bins, W, H, pipe.tile_h, pipe.tile_w, False)
    return tri_id.numpy()[:H, :W]


def _env_precompute(pipe):
    """(sky faces at mip 0, prefiltered mips) in float64: the port's own
    precompute, redone from the scene's sky as the pipeline does it."""
    cube = pipe.scene.skybox.cubemap
    base = torch.as_tensor(
        np.stack([f.mip_array_rgba(0)[..., :3] for f in cube.faces]).astype(np.float32))
    src = ibl.build_cubemap_mips(base, int(np.log2(base.shape[1])) + 1)
    prefiltered = ibl.prefilter_env_map(src, out_size=pipe.prefilter_size)
    return base.numpy().astype(np.float64), [m.numpy().astype(np.float64) for m in prefiltered]


def _scalar_frame(pipe, cam, tri_id):
    """(uint8-scale float64 frame, average luminance) of the float64
    transcription over `tri_id`, the per-pixel loop of
    test_frame_transcription's full-frame test."""
    cfg, p = pipe.config, pipe.packed
    fov, ratio, near, far = cfg.fov, cfg.ratio, cfg.near, cfg.far
    view = np.asarray(cam.view_matrix(), np.float64)
    inv_view = np.asarray(cam.world_matrix(), np.float64)
    view_proj = np.asarray(cam.projection_matrix(), np.float64) @ view
    camera_pos = np.asarray(cam.position, np.float64)
    sh_pack = np.asarray(pipe.sh_pack, np.float64)
    sky_faces, prefiltered = _env_precompute(pipe)
    lut = pipe.brdf_lut.numpy().astype(np.float64)

    light_rows = []
    for j in range(len(p.light_pos)):
        r, kc, kl, kq = p.light_attenuation[j]
        inten = p.light_intensity[j]
        light_rows.append(np.array([
            *p.light_pos[j], *p.light_color[j], inten, kc, kl, kq, 0, 0, 0,
            r * CULLING_RADIUS_COEFFICIENT * math.sqrt(max(inten, 0.0)),
        ], np.float64))
    mats = p.materials
    mm = np.asarray(p.model_mats, np.float64)
    imm = np.asarray(p.inv_model_mats, np.float64)
    positions = np.asarray(p.positions, np.float64)
    normals = np.asarray(p.normals, np.float64)

    hdr = np.zeros((H, W, 3), np.float64)
    for py in range(H):
        for px in range(W):
            t = int(tri_id[py, px])
            uv = ((px + 0.5) / W, (py + 0.5) / H)
            if t < 0:   # skybox.hlsl: the cubemap along the pixel's ray
                near_h = 2 * near * math.tan(fov / 2)
                near_w = near_h * ratio
                camv = inv_view[:3, :3] @ np.array(
                    [(uv[0] - 0.5) * near_w, (0.5 - uv[1]) * near_h, near])
                hdr[py, px] = tx.cube_sample(sky_faces, camv / np.linalg.norm(camv))
                continue
            inst = int(p.tri_instance[t])
            vid = p.tris[t]
            nmat = imm[inst][:3, :3].T
            vw = [mm[inst] @ np.append(positions[i], 1.0) for i in vid]
            nw = [nmat @ normals[i] for i in vid]
            clip = [view_proj @ v for v in vw]
            sp = [((v[0] / v[3] * 0.5 + 0.5) * W, (1.0 - (v[1] / v[3] * 0.5 + 0.5)) * H)
                  for v in clip]
            (x0, y0), (x1, y1), (x2, y2) = sp
            qx, qy = px + 0.5, py + 0.5
            area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
            l0 = ((x1 - qx) * (y2 - qy) - (x2 - qx) * (y1 - qy)) / area
            l1 = ((x2 - qx) * (y0 - qy) - (x0 - qx) * (y2 - qy)) / area
            ls = np.array([l0, l1, 1.0 - l0 - l1])
            depth_ndc = float(ls @ np.array([v[2] / v[3] for v in clip]))
            pw = ls / np.array([v[3] for v in clip])
            pw = pw / pw.sum()
            normal_in = pw[0] * nw[0] + pw[1] * nw[1] + pw[2] * nw[2]
            mi = int(p.tri_material[t])
            gba, gbb, gbc = tx.gbuffer_ps(mats.albedo[mi], float(mats.emission[mi]),
                                          float(mats.roughness[mi]), float(mats.metallic[mi]),
                                          normal_in)
            hdr[py, px] = tx.deferred_ps(uv, gba, gbb, gbc, depth_ndc, sh_pack, prefiltered,
                                         lut, light_rows, view, inv_view, camera_pos, fov,
                                         ratio, near, far)
    out = tx.np_bloom(hdr)
    avg = tx.np_exposure(out, 0.0, tx.FRAME_DT)
    return tx.np_tonemap(out, avg), avg


@pytest.fixture(scope="module")
def transcription():
    """The scalar frame over the port's raster pick, built once."""
    scene, cfg, cam = _tx_setup()
    pipe = DeferredRenderPipeline(scene, cfg, device="cpu", **TX_KNOBS)
    return _scalar_frame(pipe, cam, _raster_pick(pipe, cam))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_frame_matches_scalar_transcription(transcription, use_pallas):
    img_scalar, avg = transcription
    scene, cfg, cam = _tx_setup()
    pipe = DeferredRenderPipeline(scene, cfg, use_pallas=use_pallas, device="cpu", **TX_KNOBS)
    assert pipe.use_pallas == use_pallas and not pipe.use_tex_kernel
    img = pipe.render(cam, delta_time=tx.FRAME_DT).numpy().astype(np.float64)
    diff = np.abs(img_scalar - img)
    assert diff.max() <= 1.0, diff.max()
    assert float(np.sqrt(np.mean((diff / 255.0) ** 2))) <= 1.5e-3
    assert abs(float(pipe.avg_luminance) - avg) / max(avg, 1e-9) < 1e-3


@pytest.mark.parametrize("tile", [(12, 64), (24, 128)], ids=["planar-cache", "fused-cache"])
def test_cache_path_frame_equals_jax_frame(tile):
    scene, cfg, cam = _tx_setup()
    knobs = dict(TX_KNOBS, tile_h=tile[0], tile_w=tile[1], use_pallas=True, use_tex_kernel=True)
    jp = JaxPipeline(scene, cfg, pallas_interpret=True, **knobs)
    tp = DeferredRenderPipeline(scene, cfg, device="cpu", **knobs)
    assert tp.use_tex_kernel and tp.use_fused_gbuffer == (tile[1] == 128)
    assert jp.use_fused_gbuffer == tp.use_fused_gbuffer
    want = np.asarray(jp.render(cam, delta_time=tx.FRAME_DT))
    got = tp.render(cam, delta_time=tx.FRAME_DT).numpy()
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats)


@pytest.mark.parametrize("emissive", [False, True], ids=["sphere", "emissive"])
def test_frame_matches_golden(emissive):
    golden = GOLDEN_DIR / ("emissive_256x192.png" if emissive else "sphere_256x192.png")
    cfg = RenderConfig(width=256, height=192, max_triangles=2048, max_vertices=2048,
                       max_instances=4, max_lights=16)
    pipe = DeferredRenderPipeline(build_scene(emissive=emissive), cfg, tile_h=24, tile_w=128,
                                  bin_cap=512, prefilter_size=16, brdf_lut_size=32,
                                  device="cpu")
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)
    for _ in range(2):
        img = pipe.render(cam, delta_time=0.25).numpy()
    assert fidelity.compare_to_golden(img, golden, tol=2e-3) <= 2e-3


def test_fidelity_copy_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
    f = rng.random((12, 16, 3), dtype=np.float32)
    for x, y in ((a, b), (a, a), (f, b), (f, f)):
        assert fidelity.rmse(x, y) == jax_fidelity.rmse(x, y)
    path = tmp_path / "golden.png"
    with pytest.raises(FileNotFoundError):   # the port never writes a golden
        fidelity.compare_to_golden(a, path, tol=0.0)
    Image.fromarray(a).save(path)
    assert fidelity.compare_to_golden(a, path, tol=0.0) == 0.0
    with pytest.raises(AssertionError, match="golden mismatch"):
        fidelity.compare_to_golden(b, path, tol=1e-3)
    with pytest.raises(ValueError, match="shape mismatch"):
        fidelity.rmse(a, a[:4])
