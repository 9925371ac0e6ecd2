"""The span metrics read the program's spans from the record (`spans.py`),
and read nothing where the run has none: a process not started as a cell's
run, a program without the tracer, a band cell."""

import argparse
import sys

import pytest

from benchmark import cells, spans

READS = {"geometry_ms": "gbuffer.geometry", "binning_ms": "gbuffer.binning",
         "raster_ms": "gbuffer.raster", "tex_plan_ms": "gbuffer.tex_plan",
         "tex_resolve_ms": "gbuffer.tex_resolve", "env_plan_ms": "shade.env_plan"}


def _rec():
    device = {name: 0.5 + i for i, name in enumerate(READS.values())}
    return {"spans": {"summary": {"frames": 32, "device": device, "host": {},
                                  "seam_ms": 0.125, "seams": {"caller": 31}},
                      "seams": [["caller", 0.125]] * 31, "seam_ms": 0.125, "counters": {},
                      "calibration_error_ns": 900}}


@pytest.mark.parametrize("metric", sorted(READS))
def test_span_metrics_read_their_span(metric):
    rec = _rec()
    assert cells.reader(metric)(rec) == rec["spans"]["summary"]["device"][READS[metric]]


def test_frame_seam_reads_the_mean_seam():
    assert cells.reader("frame_seam_ms")(_rec()) == 0.125


def test_a_span_that_did_not_run_reads_none():
    rec = _rec()
    del rec["spans"]["summary"]["device"]["shade.env_plan"]
    assert cells.reader("env_plan_ms")(rec) is None


def test_no_spans_outside_a_cell_run(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["pytest"])
    rec = {}
    assert all(cells.reader(m)(rec) is None for m in [*READS, "frame_seam_ms"])
    assert rec == {"spans": None}


def test_no_spans_from_a_program_without_the_tracer(monkeypatch):
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    monkeypatch.delattr(DeferredRenderPipeline, "start_trace")
    assert spans.take(argparse.Namespace(workload="terrain_stream", seed=1)) is None


def test_no_spans_in_a_band_cell():
    assert spans.take(argparse.Namespace(workload="terrain_bands4", seed=1)) is None


def test_the_cell_arguments_are_the_runs(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py", "--workload", "terrain_stream",
                                      "--seed", "5200000001", "--seconds", "20", "--trace", "1"])
    args = spans._cell_args()
    assert (args.workload, args.seed) == ("terrain_stream", 5200000001)


def test_span_metrics_are_listed_where_the_spans_are():
    spec = cells.spec()
    per = {m["name"]: m for m in spec["per_layer"]}
    for m in READS:
        assert per[m]["workloads"] == ["terrain_stream", "lights1k_stream"]
        assert per[m]["moves"] == "frame_ms" and per[m]["source"] == "device_trace"
    assert per["frame_seam_ms"]["workloads"] == ["terrain_stream", "lights1k_stream",
                                                 "terrain_interactive"]
