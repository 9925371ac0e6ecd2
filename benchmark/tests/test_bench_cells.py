"""Every cell of BENCHMARK.json resolves to its files by name, and the file
keeps to the benchmark's contract where a CPU can check it."""

import json
import re

import pytest

from benchmark import cells

SPEC = cells.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(name):
    cl = cells.cell(name, SPEC)
    assert cl["config"]["name"] == cl["workload"]["config"]
    assert cl["traffic"]["loop"] in ("stream", "interactive", "bands")
    assert {"off2_share", "carry_gap", "stats_off"} <= set(cl["config"]["limits"]) <= {
        "off2_share", "off1_share", "carry_gap", "stats_off"}
    assert cl["config"]["control"] in ("program_bf16", "reference_bf16")
    for m in cl["per_layer"]:
        assert callable(cells.reader(m["name"]))
    reported = {m["name"] for m in cl["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert cl["per_layer"]


def test_names_units_and_keys():
    top = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(SPEC) == top
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert set(c["reduced"]) <= set(json.load(open(cells.ROOT / c["file"]))["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                           "moves"}
        for wl in m.get("workloads", []):
            assert wl in {w["name"] for w in SPEC["workloads"]}
    moves = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in moves for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_new_cell_needs_no_edit():
    """A cell added as an entry and data files is found with no code change."""
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "terrain_new", "config": "terrain262k",
                              "traffic": "stream", "chips": 1, "why": "test"})
    cl = cells.cell("terrain_new", spec)
    assert cl["traffic"]["loop"] == "stream"
    assert {m["name"] for m in cl["end_to_end"]} == {
        m["name"] for m in SPEC["end_to_end"] if "workloads" not in m}
