"""On the card: each one-card cell's run comes out correct at its full
size, with a short window; its control comes out not correct.

    python -m pytest benchmark/tests/test_bench_cuda.py -q   (on a machine with a card)
"""

import json

import pytest

from benchmark import cells, run

ONE_CARD = [w["name"] for w in cells.spec()["workloads"] if w["chips"] == 1]


def verdict(name, capsys, **kw):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cl = cells.cell(name, cells.spec())
    res = run.run_single(cl, 2**31 + 11, 2.0, False, "cuda", **kw)
    assert run.report(cl, res, False, run.device_info(1)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_cell_is_correct(name, cuda_device, capsys):
    line = verdict(name, capsys)
    assert line["correct"] and line["failed"] == 0
    assert line["metrics"]["frame_ms"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["terrain_stream", "lights1k_stream"])
def test_control_is_not_correct(name, cuda_device, capsys):
    assert not verdict(name, capsys, control=True)["correct"]
