"""The port's band frame (`parallel/frame_sharded.py`) on a CUDA device.
Needs the card and the CUDA toolkit: marked `cuda`, skipped elsewhere
(`python -m pytest --noconftest tests/test_torch_sharded_cuda.py` on a GPU
machine without JAX).

The textured stress terrain (32x16 cells, a sky, chip_smoke's cache knobs)
at 256x192 on the fused path:

* Two gloo ranks share card 0 in 96-row bands: each rank's band frame
  launches kernels A, B (four covers), C and D, whose calls at its band
  offset equal their plain versions at the kernels line's bars
  (`chip_smoke.hold_call`), and the gathered frame is held to the
  single-card `render()` of the same pose (rmse <= 1e-3 on uint8/255, fewer
  than 1e-3 of the pixels off by more than 1).
* One NCCL rank, the whole frame captured as one CUDA graph: over a yaw
  path with the exposure carry chained on the device, each captured band
  frame equals the eager one (`eager()`) and the single-card `render()` of
  the same pose from the same carry bit for bit, with equal `collect_stats`
  outputs (the captured `render()`'s counter vector); one capture serves
  the path and each replay launches A 1, B 4, C 1, D 1; with the sync
  debug mode at "error" the replays (and `frame_args`' uploads) make no
  host sync; a changed `tex_caps` captures again and the frame follows it;
  `time_collectives` on the captured frame raises ValueError.
* Two gloo ranks on card 0 capture the band body only: each captured frame
  (the graph's band body, then the eager post chain) equals the eager band
  frame bit for bit, with equal `collect_stats` outputs.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import BAND_A_D, KERNELS, hold_call, read_launches, recording, reset_launches
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.parallel import frame_sharded
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline, eager

pytestmark = pytest.mark.cuda
W, H = 256, 192


def _cell(device):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = RenderConfig(W, H, max_instances=2)
    pipe = DeferredRenderPipeline(chip_smoke.stress_scene(32, 16, 64, 80.0), cfg,
                                  device=device, tex_caps=chip_smoke.TEX_CAPS,
                                  **dict(chip_smoke.BASE_KNOBS, bin_cap=2048,
                                         brdf_lut_size=chip_smoke.BRDF_LUT))
    return pipe, chip_smoke.cell_camera(cfg)


def _band_rank(mesh):
    pipe, cam = _cell(mesh.device)
    frame = frame_sharded.build_sharded_frame(mesh, pipe, collect_stats=True)
    args = frame_sharded.frame_args(pipe, cam, pipe.avg_luminance)
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


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _nccl_rank(mesh):
    """One NCCL rank: the captured band frame against eager band frames and
    `render()`; no host sync; a changed knob; time_collectives."""
    pipe, cam = _cell(mesh.device)
    frame = frame_sharded.build_sharded_frame(mesh, pipe, collect_stats=True)
    out = dict(equal_eager=[], equal_render=[], launches=[])
    carry = pipe.avg_luminance
    with torch.no_grad():
        for c in chip_smoke.camera_path(cam, 3):
            args = frame_sharded.frame_args(pipe, c, carry)
            with eager():
                want = frame(*args)
            first = frame.captured
            before = read_launches()
            got = frame(*args)
            torch.cuda.synchronize()
            if first is not None:
                out["launches"].append({k: n - before[k] for k, n in read_launches().items()
                                        if n != before[k]})
            out["equal_eager"].append(_equal(got, want))
            pipe.avg_luminance = carry
            single = pipe.render(c, collect_stats=False)
            stats = pipe.captured_frame.stats
            nb = got[2].numel()
            out["equal_render"].append(
                torch.equal(got[0], single) and torch.equal(got[1], pipe.avg_luminance)
                and torch.equal(got[2].to(torch.int32), stats[:nb])
                and torch.equal(torch.stack(got[3:]).to(torch.int32),
                                stats[nb + 2:][[0, 2, 1]]))
            carry = got[1]
        out["one_capture"] = frame.captured is not None and frame.captured is first
        out["lit"] = float((got[0].max(-1).values > 16).float().mean())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for c in chip_smoke.camera_path(cam, 4):
                carry = frame(*frame_sharded.frame_args(pipe, c, carry))[1]
            out["sync"] = None
        except RuntimeError as e:
            out["sync"] = str(e)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        first = frame.captured
        pipe.tex_caps = (60, 28, None, (16, 8))
        args = frame_sharded.frame_args(pipe, cam, carry)
        with eager():
            want = frame(*args)
        got = frame(*args)
        out["recaptured"] = frame.captured is not first
        out["equal_after_knob"] = _equal(got, want)
        mesh.time_collectives = True
        try:
            frame(*args)
            out["time_collectives"] = None
        except ValueError as e:
            out["time_collectives"] = str(e)
    return out


def _gloo_rank(mesh):
    """Two gloo ranks on one card: the captured band body and the eager
    post chain against eager band frames."""
    pipe, cam = _cell(mesh.device)
    frame = frame_sharded.build_sharded_frame(mesh, pipe, collect_stats=True)
    equal, carry = [], pipe.avg_luminance
    with torch.no_grad():
        for c in chip_smoke.camera_path(cam, 3):
            args = frame_sharded.frame_args(pipe, c, carry)
            with eager():
                want = frame(*args)
            got = frame(*args)
            equal.append(_equal(got, want))
            carry = got[1]
    return dict(equal=equal, band_body=len(frame.captured.outputs) == 2)


@pytest.fixture(scope="module")
def nccl_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return frame_sharded.launch(1, _nccl_rank, device="cuda")[0]


def test_nccl_captured_band_frame_equals_eager_and_render(nccl_run):
    assert nccl_run["equal_eager"] == [True] * 3
    assert nccl_run["equal_render"] == [True] * 3
    assert nccl_run["one_capture"] and nccl_run["lit"] > 0.05
    assert nccl_run["launches"] == [dict(BAND_A_D)] * 2


def test_nccl_band_frame_replays_make_no_host_sync(nccl_run):
    assert nccl_run["sync"] is None


def test_nccl_band_frame_captures_again_on_a_changed_knob(nccl_run):
    assert nccl_run["recaptured"] and nccl_run["equal_after_knob"]


def test_captured_nccl_band_frame_refuses_time_collectives(nccl_run):
    assert "profiler" in (nccl_run["time_collectives"] or "")


def test_gloo_captured_band_body_equals_eager_band_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for out in frame_sharded.launch(2, _gloo_rank, device="cuda:0"):
        assert out == dict(equal=[True] * 3, band_body=True)
