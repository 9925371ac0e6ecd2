"""The anisotropic sampler's metrics (`metrics/aniso_*.py`): each span
metric reads its span and nothing without it; the roofline is the bound
of the reference's texture counts over the two spans' time, and reads
nothing without either span or the counts; the three are listed for
`terrain_aniso_stream` alone, and the cell resolves to its files."""

import pytest

from benchmark import cells

SPANS = {"aniso_footprint_ms": "gbuffer.aniso_footprint", "aniso_taps_ms": "gbuffer.aniso_taps"}
METRICS = (*SPANS, "aniso_sampler_roofline")


def _rec(footprint=0.25, taps=0.75, counts=True):
    device = {"gbuffer.tex_resolve": 1.5}
    if footprint is not None:
        device["gbuffer.aniso_footprint"] = footprint
    if taps is not None:
        device["gbuffer.aniso_taps"] = taps
    rec = {"spans": {"summary": {"frames": 32, "device": device, "host": {}},
                     "seams": [], "seam_ms": None, "counters": {}, "calibration_error_ns": 0}}
    if counts:
        rec["counts"] = {"pixels": 2000, "covered": 1000, "tex_samples": 1000, "tex_taps": 4000}
    return rec


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_metrics_read_their_span(metric):
    rec = _rec()
    assert cells.reader(metric)(rec) == rec["spans"]["summary"]["device"][SPANS[metric]]
    assert cells.reader(metric)(_rec(footprint=None, taps=None)) is None


def test_the_roofline_is_the_bound_over_the_spans():
    # 156 operations a trilinear tap and 30 a sample at 67 TFLOP/s, above
    # 16 bytes a sample at 3.35 TB/s; over the spans' 0.25 + 0.75 ms
    ops_ms = (156 * 4000 + 30 * 1000) / 67e12 * 1e3
    assert ops_ms > 16 * 1000 / 3.35e12 * 1e3
    assert cells.reader("aniso_sampler_roofline")(_rec()) == pytest.approx(100.0 * ops_ms / 1.0,
                                                                           rel=1e-12)


@pytest.mark.parametrize("rec", [_rec(footprint=None), _rec(taps=None), _rec(counts=False),
                                 {"spans": None, "counts": {"tex_samples": 1, "tex_taps": 4}}],
                         ids=["no-footprint", "no-taps", "no-counts", "no-spans"])
def test_the_roofline_reads_none_without_its_inputs(rec):
    assert cells.reader("aniso_sampler_roofline")(rec) is None


def test_the_metrics_are_listed_for_the_aniso_cell_alone():
    per = {m["name"]: m for m in cells.spec()["per_layer"]}
    for m in METRICS:
        assert per[m]["workloads"] == ["terrain_aniso_stream"]
        assert per[m]["moves"] == "frame_ms" and per[m]["source"] == "device_trace"
    assert per["aniso_sampler_roofline"]["layer"] == "kernels"
    assert per["aniso_sampler_roofline"]["unit"] == "%"


def test_the_aniso_cell_resolves():
    cl = cells.cell("terrain_aniso_stream", cells.spec())
    assert cl["config"]["pipeline"]["texture_filter"] == "anisotropic"
    assert cl["config"]["control"] == "reference_bf16"
    assert cl["config"]["limits"] == {"off2_share": 2e-5, "off1_share": 0.07,
                                      "carry_gap": 2e-5, "stats_off": 0}
    assert cl["traffic"]["loop"] == "stream" and cl["workload"]["chips"] == 1
    assert "frame_ms" in {m["name"] for m in cl["end_to_end"]}
    assert set(METRICS) <= {m["name"] for m in cl["per_layer"]}
