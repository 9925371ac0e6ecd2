"""The port's bench entry (`direct12pbrrenderer_tpu_torch.bench`) on the CPU.

* `--smoke --device cpu` prints one JSON line with `bench.py`'s smoke keys
  plus `device` and `reference_scene`; without `--device` and with no card
  it raises.
* The reference-scene cell: `--asset-root` and `--texture-filter` are
  accepted with `bench.py`'s choices. On a console-built tree holding the
  App's default scene the port's App at the AppConfig defaults (at 256x96,
  one frame, its pipeline and the gate's with a 32x32 BRDF LUT) is the
  headline, measured with its binding gate, with either filter; the stress
  cells follow unless `--skip-secondary`. Without the scene the cell reads
  "not measured" with the path it looked for (the stress cells stubbed).
* `tools.tiny_scene.tiny_pipeline` renders `__graft_entry__._tiny_pipeline`'s
  frame.
* Knob parity with the repo's `bench.py`: its pipeline class and
  `build_stress_scene` are replaced by recorders that keep their arguments
  and raise, so its cells and its gate's reference pipeline are recorded
  without rendering; the port's must pass the same values (the reference
  may add the content knobs atlas_max_dim, brdf_lut_size, prefilter_size,
  and both may add `device`).
* The two stress cells run at `cells=(16, 8)`, 256x192, 2 frames, with the
  pipeline class wrapped so that the benched pipelines take the card's
  defaults (`use_pallas` and `use_tex_kernel` True, each kernel's plain
  version here) and a 16x16 BRDF LUT (the bench's 512x512 one takes about
  40 s on two CPU threads).
* The binding gate: a first rmse of 2e-3 moves the cell's fps and rmse to
  its `tuned` keys and re-measures on the gate-safe configuration, whose
  own FrameStats the cell then reports.
"""

import argparse
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench as jax_bench
import chip_smoke
import direct12pbrrenderer_tpu.pipeline.deferred as jax_deferred
import direct12pbrrenderer_tpu.tools.stress_scene as jax_stress
from direct12pbrrenderer_tpu_torch import bench
from direct12pbrrenderer_tpu_torch.app import app
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline, FrameStats
from direct12pbrrenderer_tpu_torch.resource import loader as tloader
from direct12pbrrenderer_tpu_torch.tools import tiny_scene
from test_torch_app import small_lut
from test_torch_assets import _write_sources
from test_torch_console import console_tree

torch.set_num_threads(2)
SMOKE_KEYS = {"metric", "value", "unit", "vs_baseline", "per_call_loop_fps", "headline_method",
              "reference_scene_vs_baseline", "vs_baseline_scene", "device", "reference_scene"}
CELL_KEYS = ("fps", "per_call_loop_fps", "sequence_dispatch_fps", "headline_method", "rmse",
             "rmse_gate", "bin_overflow", "tex_approx_taps", "env_approx_taps")
SMALL = argparse.Namespace(width=256, height=192, device="cpu")


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_smoke_prints_one_json_line(capsys):
    result = bench.main(["--smoke", "--device", "cpu"])
    assert _last_json(capsys) == result
    assert SMOKE_KEYS <= set(result)
    assert result["value"] > 0 and result["headline_method"] == "loop"
    assert result["device"] == "cpu" and result["unit"] == "fps"
    assert result["reference_scene"].startswith("not measured")
    assert result["rmse_gate"] == "pass" and bench.failed_gates(result) == []


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--smoke"])


def stub_stress_cells(monkeypatch) -> list[str]:
    """Replaces the two stress cells by stubs that return fixed cells;
    returns the names of the cells called, in order."""
    called = []

    def stub(name, out):
        def cell(args, frames):
            called.append(name)
            return dict(out)
        monkeypatch.setattr(bench, name, cell)

    stub("_stress_bench", {"sponza_class_triangles": 2, "sponza_class_fps": 30.0,
                           "sponza_class_rmse_gate": "pass"})
    stub("_lights1k_bench", {"lights1k_fps": 20.0, "lights1k_rmse_gate": "pass"})
    return called


@pytest.mark.parametrize("flag", [["--asset-root", "assets"], ["--texture-filter", "bilinear"]],
                         ids=["asset-root", "texture-filter"])
def test_reference_scene_flags_are_rejected(flag, tmp_path, monkeypatch, capsys):
    # bench.py's reference-scene flags are accepted, with bench.py's choices
    # (a filter outside them is rejected); without the App's scene under the
    # asset root the cell reads "not measured" with the path it looked for,
    # nothing stands in for it, and sponza_class is the headline
    called = stub_stress_cells(monkeypatch)
    monkeypatch.chdir(tmp_path)
    result = bench.main(["--device", "cpu", "--frames", "1", *flag])
    root = pathlib.Path("assets" if flag[0] == "--asset-root" else app.DEFAULT_ASSET_ROOT)
    assert result["reference_scene"] == \
        f"not measured: no scene at {root / 'Asset/Scene/main.json'}"
    assert result["reference_scene_vs_baseline"] is None
    assert result["vs_baseline_scene"] == "sponza_class" and result["value"] == 30.0
    assert called == ["_stress_bench", "_lights1k_bench"]
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--texture-filter", "nearest"])
    assert exc.value.code == 2 and "invalid choice" in capsys.readouterr().err


@pytest.fixture
def reference_tree(tmp_path, monkeypatch):
    """A console-built tree (`test_torch_console.console_tree`) with the
    App's default scene; the App's and the bench's pipelines take a 32x32
    BRDF LUT (the App's 512x512 one takes about 30 s on two CPU threads)."""
    src = tmp_path / "src"
    _write_sources(src)
    old = tloader.ResourceLoader._instance
    root = console_tree("port", src, tmp_path / "tree")
    small_lut(monkeypatch, app)
    small_lut(monkeypatch, bench)
    yield root
    tloader.ResourceLoader._instance = old


@pytest.mark.parametrize("texture_filter", ["trilinear", "bilinear"])
def test_reference_scene_cell_is_measured_with_its_gate(reference_tree, monkeypatch, capsys,
                                                        texture_filter):
    called = stub_stress_cells(monkeypatch)
    built = []
    real_app = bench.App

    def app_and_record(cfg):
        built.append(real_app(cfg))
        return built[-1]

    monkeypatch.setattr(bench, "App", app_and_record)
    result = bench.main(["--asset-root", str(reference_tree), "--device", "cpu", "--frames", "1",
                         "--width", "256", "--height", "96", "--skip-secondary",
                         "--texture-filter", texture_filter])
    assert _last_json(capsys) == result and called == []
    assert result["reference_scene"] == str(reference_tree / "Asset/Scene/main.json")
    assert result["metric"] == "deferred PBR frame rate, reference scene @ 256x96"
    assert result["vs_baseline_scene"] == "reference_scene"
    assert result["value"] > 0 and result["reference_scene_vs_baseline"] == result["vs_baseline"]
    assert result["rmse_gate"] == "pass" and result["rmse_vs_xla"] <= 1e-3
    assert "fidelity_fallback" not in result and bench.failed_gates(result) == []
    assert (result["bin_overflow"], result["tex_approx_taps"], result["env_approx_taps"]) == \
        (0, 0, 0)
    (a,) = built   # the App at the AppConfig defaults but the size and the frames
    want = dataclasses.replace(app.AppConfig(), asset_root=str(reference_tree), width=256,
                               height=96, frames=1, device="cpu")
    assert a.cfg == want


def test_reference_scene_cell_leads_the_secondary_cells(reference_tree, monkeypatch):
    called = stub_stress_cells(monkeypatch)
    monkeypatch.setattr(bench, "_reference_bench", lambda args, frames: {
        "fps": 12.0, "rmse": 0.0, "rmse_gate": "pass", "bin_overflow": 0,
        "tex_approx_taps": 0, "env_approx_taps": 0})
    result = bench.main(["--asset-root", str(reference_tree), "--device", "cpu"])
    assert called == ["_stress_bench", "_lights1k_bench"]
    assert result["value"] == 12.0 and result["reference_scene_vs_baseline"] == 12.0 / 60.0
    assert result["vs_baseline"] == 30.0 / 60.0 and result["vs_baseline_scene"] == "sponza_class"
    assert result["lights1k_fps"] == 20.0 and result["sponza_class_fps"] == 30.0


def test_tiny_pipeline_matches_graft_entry():
    jp, jcam, jcfg = graft._tiny_pipeline()
    tp, tcam, tcfg = tiny_scene.tiny_pipeline("cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = np.asarray(jp.render(jcam))
    got = tp.render(tcam).numpy()
    assert (want.max(-1) > 16).mean() > 0.05
    rmse = np.sqrt(np.mean((got / 255.0 - want / 255.0) ** 2))
    assert rmse <= 1e-3, rmse
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats)


class _Stop(Exception):
    pass


def _recorder(calls, returns=None):
    """Keeps each call's (args, kwargs); raises unless given a return value."""
    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        if returns is None:
            raise _Stop
        return returns
    return rec


def _record_cell(monkeypatch, cell, pipe_module, scene_module, args):
    """(build_stress_scene's kwargs, pipeline's config fields, pipeline's kwargs)
    of `cell(args)` with `scene_module.build_stress_scene` and
    `pipe_module.DeferredRenderPipeline` replaced by recorders."""
    scenes, pipes = [], []
    monkeypatch.setattr(scene_module, "build_stress_scene", _recorder(scenes))
    with pytest.raises(_Stop):
        cell(args)
    monkeypatch.setattr(scene_module, "build_stress_scene", _recorder([], returns="scene"))
    monkeypatch.setattr(pipe_module, "DeferredRenderPipeline", _recorder(pipes))
    with pytest.raises(_Stop):
        cell(args)
    ((scene_args, scene_kw),), ((pipe_args, pipe_kw),) = scenes, pipes
    assert scene_args == () and pipe_args[0] == "scene" and len(pipe_args) == 2
    return scene_kw, dataclasses.asdict(pipe_args[1]), pipe_kw


@pytest.mark.parametrize("cell", ["_stress_bench", "_lights1k_bench"])
def test_cells_use_bench_py_knobs(monkeypatch, cell):
    full = dict(width=1920, height=1080)
    want = _record_cell(monkeypatch, getattr(jax_bench, cell), jax_deferred, jax_stress,
                        argparse.Namespace(**full))
    scene_kw, cfg, pipe_kw = _record_cell(monkeypatch, getattr(bench, cell), bench, bench,
                                          argparse.Namespace(**full, device="cpu"))
    assert pipe_kw.pop("device") == "cpu"
    assert (scene_kw, cfg, pipe_kw) == want

    # the gate's reference pipeline, for this cell's benched pipeline
    monkeypatch.undo()
    pipe = argparse.Namespace(
        scene="scene", config=RenderConfig(**cfg), tile_h=pipe_kw["tile_h"],
        tile_w=pipe_kw["tile_w"], bin_cap=pipe_kw["bin_cap"],
        max_active_lights=pipe_kw.get("max_active_lights", 64), texture_filter="trilinear",
        atlas_max_dim=pipe_kw["atlas_max_dim"], brdf_lut_size=512, prefilter_size=None,
        device="cpu")
    jax_refs, port_refs = [], []
    monkeypatch.setattr(jax_deferred, "DeferredRenderPipeline", _recorder(jax_refs))
    monkeypatch.setattr(bench, "DeferredRenderPipeline", _recorder(port_refs))
    with pytest.raises(_Stop):
        jax_bench._rmse_vs_xla("scene", pipe, "camera")
    with pytest.raises(_Stop):
        bench._rmse_vs_plain(pipe, "camera")
    ((jargs, jkw),), ((pargs, pkw),) = jax_refs, port_refs
    assert pargs == jargs
    added = {k: pkw.pop(k) for k in set(pkw) - set(jkw)}
    assert added == {"atlas_max_dim": pipe.atlas_max_dim, "brdf_lut_size": 512,
                     "prefilter_size": None, "device": "cpu"}
    assert pkw == jkw


@pytest.fixture
def card_defaults(monkeypatch):
    """Wraps the bench's pipeline class: `use_pallas` and `use_tex_kernel`
    default to True (the card's resolution) and the BRDF LUT is 16x16.
    Returns the pipelines built, in order."""
    built = []

    class CardDefaults(DeferredRenderPipeline):
        def __init__(self, *args, use_pallas=None, use_tex_kernel=None, **kwargs):
            kwargs["brdf_lut_size"] = 16
            super().__init__(*args, use_pallas=True if use_pallas is None else use_pallas,
                             use_tex_kernel=True if use_tex_kernel is None else use_tex_kernel,
                             **kwargs)
            built.append(self)

    monkeypatch.setattr(bench, "DeferredRenderPipeline", CardDefaults)
    return built


def test_stress_cells_run(card_defaults):
    out = bench._stress_bench(SMALL, frames=2, cells=(16, 8))
    assert set(out) == {"sponza_class_triangles", *(f"sponza_class_{k}" for k in CELL_KEYS)}
    assert out["sponza_class_triangles"] == 16 * 8 * 2 and out["sponza_class_fps"] > 0
    assert out["sponza_class_rmse_gate"] == "pass"
    fps = (out["sponza_class_per_call_loop_fps"], out["sponza_class_sequence_dispatch_fps"])
    assert min(fps) > 0 and out["sponza_class_fps"] == max(fps)
    assert out["sponza_class_headline_method"] == ("sequence" if fps[1] > fps[0] else "loop")
    benched = card_defaults[0]
    assert benched.use_fused_gbuffer and benched.use_fused_deferred

    del card_defaults[:]
    out = bench._lights1k_bench(SMALL, frames=2, cells=(16, 8))
    assert set(out) == {"lights1k_visible", "lights1k_tile_overflow",
                        *(f"lights1k_{k}" for k in CELL_KEYS)}
    assert out["lights1k_visible"] > 64 and out["lights1k_tile_overflow"] == 0
    assert out["lights1k_rmse_gate"] == "pass"
    benched, ref = card_defaults
    assert benched.light_tile == (24, 128) and not benched.use_fused_deferred
    assert ref.light_tile is None and not (ref.use_pallas or ref.use_tex_kernel)


def _failing_once(monkeypatch):
    """Patches `_rmse_vs_plain` to return 2e-3 on its first call; returns
    the values of the later, real calls."""
    real, seen = bench._rmse_vs_plain, []

    def once(pipe, cam):
        if not seen:
            seen.append(None)
            return 2e-3
        seen.append(real(pipe, cam))
        return seen[-1]

    monkeypatch.setattr(bench, "_rmse_vs_plain", once)
    return seen


DISTINCT = FrameStats(visible_instances=1, total_instances=1, visible_lights=105,
                      bin_overflow=101, tex_approx_taps=102, env_approx_taps=103,
                      lights_truncated=0, light_tile_overflow=104)


def _distinct_stats(monkeypatch):
    """Patches the gate-safe pipeline to report DISTINCT as its FrameStats;
    returns the pipelines built."""
    real, built = bench._gate_safe_pipeline, []

    def safe(pipe):
        p = real(pipe)
        render = p.render

        def patched(cam, delta_time=1.0 / 60.0, collect_stats=True):
            img = render(cam, delta_time, collect_stats)
            if collect_stats:
                p.last_stats = DISTINCT
            return img

        p.render = patched
        built.append((pipe, p))
        return p

    monkeypatch.setattr(bench, "_gate_safe_pipeline", safe)
    return built


def test_failing_gate_binds_on_a_stress_cell(monkeypatch, card_defaults):
    seen = _failing_once(monkeypatch)
    built = _distinct_stats(monkeypatch)
    out = bench._stress_bench(SMALL, frames=2, cells=(16, 8))
    assert out["sponza_class_fidelity_fallback"] == "xla-samplers"
    assert out["sponza_class_tuned_rmse"] == 2e-3 and out["sponza_class_tuned_fps"] > 0
    assert out["sponza_class_rmse"] == seen[-1] and len(seen) == 2
    assert out["sponza_class_rmse_gate"] == "pass" and out["sponza_class_fps"] > 0
    assert (out["sponza_class_bin_overflow"], out["sponza_class_tex_approx_taps"],
            out["sponza_class_env_approx_taps"]) == (101, 102, 103)
    (benched, safe), = built
    assert not safe.use_tex_kernel and safe.tex_caps is None and safe.env_budget is None
    assert safe.use_pallas and benched.use_pallas   # the raster kernel stays
    for knob in ("tile_h", "tile_w", "bin_cap", "atlas_max_dim", "brdf_lut_size",
                 "max_active_lights", "texture_filter", "config"):
        assert getattr(safe, knob) == getattr(benched, knob), knob


def test_failing_gate_binds_on_the_headline(monkeypatch, capsys):
    seen = _failing_once(monkeypatch)
    _distinct_stats(monkeypatch)
    result = bench.main(["--smoke", "--device", "cpu", "--frames", "2"])
    assert _last_json(capsys) == result
    assert result["fidelity_fallback"] == "xla-samplers"
    assert result["tuned_rmse_vs_xla"] == 2e-3 and result["tuned_fps"] > 0
    assert result["rmse_vs_xla"] == seen[-1] and result["rmse_gate"] == "pass"
    assert (result["bin_overflow"], result["tex_approx_taps"],
            result["env_approx_taps"]) == (101, 102, 103)
    assert result["value"] == result["per_call_loop_fps"] > 0
    # the chip run refuses such a line: its fps is not the kernels' path's
    assert chip_smoke.bench_faults(result, {}) == [
        "fidelity_fallback is 'xla-samplers': the cell's numbers are the gate-safe "
        "re-measure's, not its kernels'"]


def test_gate_that_still_fails_reads_fail(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_rmse_vs_plain", lambda pipe, cam: 2e-3)
    result = bench.main(["--smoke", "--device", "cpu", "--frames", "2"])
    assert result["rmse_gate"] == "FAIL" and result["fidelity_fallback"] == "xla-samplers"
    assert bench.failed_gates(result) == ["rmse_gate"]
    assert _last_json(capsys)["rmse_gate"] == "FAIL"


FULL_LAUNCHES = {cell: dict.fromkeys(chip_smoke.KERNELS, 0) | dict.fromkeys(names, 1)
                 for cell, names in chip_smoke.BENCH_CELLS.items()}


@pytest.mark.parametrize("planted, want", [
    ({}, []),
    ({"sponza_class_fidelity_fallback": "xla-samplers"},
     ["sponza_class_fidelity_fallback is 'xla-samplers'"]),
    ({"lights1k_rmse_gate": "FAIL", "lights1k_fidelity_fallback": "xla-samplers"},
     ["lights1k_fidelity_fallback is", "gate lights1k_rmse_gate fails"]),
    ({"launches": ("lights1k", "point_lights")}, ["cell lights1k launched none of kernels "
                                                  "['point_lights']"]),
], ids=["clean", "fallback", "failing-gate", "missing-kernel"])
def test_chip_smoke_bench_faults(planted, want):
    result = {"rmse_gate": "pass", "sponza_class_rmse_gate": "pass",
              "lights1k_rmse_gate": "pass"}
    launches = {cell: dict(counts) for cell, counts in FULL_LAUNCHES.items()}
    if "launches" in planted:
        cell, kernel = planted.pop("launches")
        launches[cell][kernel] = 0
    result.update(planted)
    faults = chip_smoke.bench_faults(result, launches)
    assert len(faults) == len(want)
    for fault, start in zip(faults, want):
        assert fault.startswith(start), fault


def test_gate_safe_pipeline_takes_the_default_raster_caps():
    # as bench.py's re-measure builds it: the plain samplers, the raster
    # kernel at its default two-pass caps (the tuned raster_caps left out)
    pipe, _, _ = tiny_scene.tiny_pipeline("cpu")
    pipe.raster_caps, pipe.tex_caps, pipe.env_budget = (128, 4), (92, 44), 64
    safe = bench._gate_safe_pipeline(pipe)
    assert safe.raster_caps is None and safe.tex_caps is None and safe.env_budget is None
    assert not safe.use_tex_kernel and safe.use_pallas == pipe.use_pallas


def test_chip_smoke_fail_names_the_phase_on_both_streams(capsys):
    """A failed phase exits 1 and names itself on stdout and on stderr, so a
    run whose stderr alone is kept still says which check failed."""
    with pytest.raises(SystemExit) as exc:
        chip_smoke.fail("lights1k", "planted")
    out, err = capsys.readouterr()
    assert exc.value.code == 1
    assert out == err == "[lights1k] FAIL planted\n"
