"""A run of the harness with the timed path broken underneath comes out
not correct: the exposure carry left unchanged by every frame, half of
each frame's rows left out, one block of each frame altered where it is
produced, every counter the frames report read one too high. The same run
unbroken comes out correct. The look for a card is
skipped; the port runs its plain versions at 64x48."""

import pytest
import torch

from benchmark import cells, run

CPU = {"platform": "cpu", "kind": "cpu", "count": 1}


def tiny_cell(name):
    cl = cells.cell(name, cells.spec())
    cfg = cl["config"]
    cfg["scene"].update(cells_x=16, cells_y=8, sky_size=16)
    cfg["render"].update(width=64, height=48)
    cfg["pipeline"].update(brdf_lut_size=16, use_pallas=False, use_tex_kernel=False)
    cl["traffic"]["period"] = 6
    return cl


def verdict(cl, capsys, **kw):
    torch.set_num_threads(2)
    res = run.run_single(cl, 2**31 + 7, 0.5, False, "cpu", **kw)
    assert run.report(cl, res, False, CPU) == 0
    import json
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "stale_carry", "half_rows", "altered", "counters"])
def test_fault_is_not_correct(fault, capsys):
    line = verdict(tiny_cell("terrain_stream"), capsys, fault=fault)
    assert line["correct"] is (fault is None)
    assert line["attempted"] >= 1
    assert set(line["checks"]) == {"off2_share", "off1_share", "carry_gap", "stats_off"}
    assert list(line)[-1] == "checks"


def test_interactive_loop_runs(capsys):
    line = verdict(tiny_cell("terrain_interactive"), capsys)
    assert line["correct"] and line["metrics"]["frame_ms"]["value"] > 0


def tiny_bands():
    cl = cells.cell("terrain_bands4", cells.spec())
    cfg = cl["config"]
    cfg["scene"].update(cells_x=16, cells_y=8, sky_size=16)
    cfg["render"].update(width=64, height=48)
    cfg["pipeline"].update(brdf_lut_size=16)
    cfg["layout"]["ranks"] = 2
    cl["traffic"]["period"] = 6
    return cl


@pytest.mark.parametrize("fault", [None, "no_exchange", "stale_carry", "half_rows", "altered",
                                   "counters"])
def test_band_fault_is_not_correct(fault, capsys, monkeypatch):
    """Two gloo ranks on the CPU: the gathered frame checked as the card's
    four NCCL ranks' is; the bands' exchange left out, the carry left
    unchanged, half the rows left out or a block altered comes out not
    correct, as does a loss counter read one too high."""
    import json

    from benchmark import bands

    # two threads a rank: with more, ranks that wait in a collective spin
    # against the one that computes, and a frame takes minutes
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    cl = tiny_bands()
    res = bands.run(cl, 2**31 + 3, 0.5, False, device="cpu", fault=fault)
    assert run.report(cl, res, False, {**CPU, "count": 2}) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is (fault is None)
