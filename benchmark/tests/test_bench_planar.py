"""The planar texture cache's metrics (`metrics/atlas_resolve_*.py`): the
span metric reads its span and nothing without it; the roofline is the
bound of the reference's texture counts over the span's time, and reads
nothing without the span or the counts; both are listed for
`terrain_planar_stream` alone, and the cell resolves to its files."""

import pytest

from benchmark import cells

SPAN = "gbuffer.atlas_resolve"
METRICS = ("atlas_resolve_ms", "atlas_resolve_roofline")


def _rec(span=0.25, counts=True):
    device = {"gbuffer.tex_resolve": 1.5}
    if span is not None:
        device[SPAN] = span
    rec = {"spans": {"summary": {"frames": 32, "device": device, "host": {}},
                     "seams": [], "seam_ms": None, "counters": {}, "calibration_error_ns": 0}}
    if counts:
        rec["counts"] = {"pixels": 2000, "covered": 1000, "tex_samples": 1000, "tex_taps": 1000}
    return rec


def test_the_span_metric_reads_its_span():
    assert cells.reader("atlas_resolve_ms")(_rec()) == 0.25
    assert cells.reader("atlas_resolve_ms")(_rec(span=None)) is None
    assert cells.reader("atlas_resolve_ms")({"spans": None}) is None


def test_the_roofline_is_the_bound_over_the_span():
    # 16 bytes a sample at 3.35 TB/s, above 125 operations a trilinear tap
    # at 67 TFLOP/s; over the span's 0.25 ms
    bytes_ms = 16 * 1000 / 3.35e12 * 1e3
    assert bytes_ms > 125 * 1000 / 67e12 * 1e3
    assert cells.reader("atlas_resolve_roofline")(_rec()) == pytest.approx(
        100.0 * bytes_ms / 0.25, rel=1e-12)


@pytest.mark.parametrize("rec", [_rec(span=None), _rec(span=0.0), _rec(counts=False),
                                 {"spans": None, "counts": {"tex_samples": 1, "tex_taps": 1}}],
                         ids=["no-span", "zero-span", "no-counts", "no-spans"])
def test_the_roofline_reads_none_without_its_inputs(rec):
    assert cells.reader("atlas_resolve_roofline")(rec) is None


def test_the_metrics_are_listed_for_the_planar_cell_alone():
    per = {m["name"]: m for m in cells.spec()["per_layer"]}
    for m in METRICS:
        assert per[m]["workloads"] == ["terrain_planar_stream"]
        assert per[m]["moves"] == "frame_ms" and per[m]["source"] == "device_trace"
    assert per["atlas_resolve_ms"]["layer"] == "GBuffer"
    assert per["atlas_resolve_roofline"]["layer"] == "kernels"
    assert per["atlas_resolve_roofline"]["unit"] == "%"


def test_the_planar_cell_resolves():
    cl = cells.cell("terrain_planar_stream", cells.spec())
    cfg = cl["config"]
    base = cells.cell("terrain_stream", cells.spec())["config"]
    assert cfg["pipeline"] == {**base["pipeline"], "tile_w": 160}
    assert (cfg["scene"], cfg["render"], cfg["layout"]) == (base["scene"], base["render"],
                                                            base["layout"])
    assert cfg["control"] == "reference_bf16"
    assert set(cfg["limits"]) == set(cfg["limits_why"]) == {"off2_share", "off1_share",
                                                            "carry_gap", "stats_off"}
    assert cl["traffic"]["loop"] == "stream" and cl["workload"]["chips"] == 1
    assert "frame_ms" in {m["name"] for m in cl["end_to_end"]}
    # and the metrics of the passes, spans and set-up this route shares
    assert {*METRICS, "idle_share", "gbuffer_ms", "shading_ms", "post_ms", "init_s",
            "capture_s"} <= {m["name"] for m in cl["per_layer"]}
