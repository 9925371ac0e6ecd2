"""The port's band frame (`parallel/frame_sharded.py`) on a CUDA device.
Needs the card and the CUDA toolkit: marked `cuda`, skipped elsewhere
(`python -m pytest --noconftest tests/test_torch_sharded_cuda.py` on a GPU
machine without JAX).

Two gloo ranks share card 0 and render the textured stress terrain (32x16
cells, a sky, chip_smoke's cache knobs) at 256x192 on the fused path in
96-row bands: each rank's band frame launches kernels A, B (four covers), C
and D, whose calls at its band offset equal their plain versions at the
kernels line's bars (`chip_smoke.hold_call`), and the gathered frame is held
to the single-card `render()` of the same pose (rmse <= 1e-3 on uint8/255,
fewer than 1e-3 of the pixels off by more than 1).
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import BAND_A_D, KERNELS, hold_call, read_launches, recording, reset_launches
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.parallel import frame_sharded
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

pytestmark = pytest.mark.cuda
W, H = 256, 192


def _band_rank(mesh):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = RenderConfig(W, H, max_instances=2)
    pipe = DeferredRenderPipeline(chip_smoke.stress_scene(32, 16, 64, 80.0), cfg,
                                  device=mesh.device, tex_caps=chip_smoke.TEX_CAPS,
                                  **dict(chip_smoke.BASE_KNOBS, bin_cap=2048,
                                         brdf_lut_size=chip_smoke.BRDF_LUT))
    cam = chip_smoke.cell_camera(cfg)
    frame = frame_sharded.build_sharded_frame(mesh, pipe, collect_stats=True)
    args = frame_sharded.frame_args(pipe, cam, float(pipe.avg_luminance))
    with torch.no_grad():
        calls = {}
        with recording(importlib.import_module("direct12pbrrenderer_tpu_torch.ops.raster_cuda"),
                       "rasterize_interp") as calls["raster_interp"], \
                recording(importlib.import_module("direct12pbrrenderer_tpu_torch.ops.cover_cuda"),
                          "fused_cover") as calls["fused_cover"], \
                recording(importlib.import_module(
                    "direct12pbrrenderer_tpu_torch.ops.resolve_shade_cuda"),
                    "resolve_shade") as calls["resolve_shade"], \
                recording(importlib.import_module("direct12pbrrenderer_tpu_torch.ops.shade_fused"),
                          "deferred_kernel") as calls["deferred_shade"]:
            frame(*args)
            torch.cuda.synchronize()
        held = {name: [hold_call("sharded-test", name, a, kw, empty_ok=True) for a, kw in c]
                for name, c in calls.items()}
        y_offsets = [kw["y_offset"] for _, kw in calls["raster_interp"]]
        del calls
        torch.cuda.synchronize()
        reset_launches()
        band, avg, bin_counts, tex, trunc, env = frame(*args)
        torch.cuda.synchronize()
        launches = read_launches()
        full = frame_sharded.gather_rows(mesh, band).cpu().numpy()
        single = pipe.render(cam).cpu().numpy() if mesh.rank == 0 else None
    return dict(held=held, y_offsets=y_offsets, launches=launches, frame=full, single=single,
                fallbacks=(int(tex), int(env), int(trunc)))


def test_band_frame_on_card_runs_a_to_d_at_band_offsets():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert set(BAND_A_D) <= set(KERNELS)
    res = frame_sharded.launch(2, _band_rank, device="cuda:0")
    for r, out in enumerate(res):
        assert out["y_offsets"] == [r * H // 2]
        assert {k: len(v) for k, v in out["held"].items()} == {
            "raster_interp": 1, "fused_cover": 4, "resolve_shade": 1, "deferred_shade": 1}
        assert all(out["launches"][k] >= n for k, n in BAND_A_D.items()), out["launches"]
        assert out["launches"]["env_resolve"] == out["launches"]["point_lights"] == 0
        assert out["fallbacks"] == (0, 0, 0)
        np.testing.assert_array_equal(out["frame"], res[0]["frame"])
    got, want = res[0]["frame"], res[0]["single"]
    assert got.shape == want.shape == (H, W, 3)
    assert (want.max(-1) > 16).mean() > 0.05
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert float(np.sqrt(np.mean((diff / 255.0) ** 2))) <= 1e-3
    assert (diff > 1).any(-1).mean() < 1e-3
