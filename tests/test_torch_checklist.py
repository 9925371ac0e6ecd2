"""The port's measurement checklist (`tools/checklist.py`, the counterpart
of `tools/tpu_checklist.py`) on the CPU.

Its `main` with `--device cpu` on a tree built by the port's console
(`test_torch_console.console_tree`) at 64x48, `--only
baseline,budget,envbudget`, prints one JSON line per check under the JAX
tool's keys and fields, then the `ALL` line holding them all. The App and
the checklist's own pipelines take the kernel path's plain versions
(`use_pallas`, `use_tex_kernel`: the env cache, whose census the envbudget
check reads) with a 32x32 BRDF LUT. The `rpc` split, the tree's absence and
an unknown check are checked too.
"""

import json

import pytest
import torch

from direct12pbrrenderer_tpu.resource import loader as jloader
from direct12pbrrenderer_tpu_torch.app import app
from direct12pbrrenderer_tpu_torch.pipeline import deferred
from direct12pbrrenderer_tpu_torch.resource import loader as tloader
from direct12pbrrenderer_tpu_torch.tools import checklist
from test_torch_app import small_lut
from test_torch_assets import _write_sources
from test_torch_console import console_tree

torch.set_num_threads(2)
KERNEL_PATH = dict(use_pallas=True, use_tex_kernel=True)
SMALL = ["--width", "64", "--height", "48", "--frames", "1", "--device", "cpu"]


@pytest.fixture
def tree(tmp_path, monkeypatch):
    old = (jloader.ResourceLoader._instance, tloader.ResourceLoader._instance)
    src = tmp_path / "src"
    _write_sources(src)
    root = console_tree("port", src, tmp_path / "port")
    small_lut(monkeypatch, app, **KERNEL_PATH)
    small_lut(monkeypatch, deferred, **KERNEL_PATH)
    yield root
    jloader.ResourceLoader._instance, tloader.ResourceLoader._instance = old


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_checklist_prints_each_check_then_all(tree, capsys):
    result = checklist.main(["--asset-root", str(tree), *SMALL,
                             "--only", "baseline,budget,envbudget"])
    lines = _lines(capsys)
    rec = result["env_census"]["recommended"]
    env_keys = ["env_budget_full", f"env_budget_{rec}", "env_budget_48"]
    keys = (["frame_baseline", "stage_budget_full", "stage_budget_448", "stage_budget_256",
             "env_census"] + env_keys)
    assert [line["check"] for line in lines] == keys[:5] + list(dict.fromkeys(env_keys)) + [
        "ALL"]
    assert lines[-1]["results"] == result and list(result) == list(dict.fromkeys(keys))
    for line in lines[:-1]:
        assert {k: v for k, v in line.items() if k != "check"} == result[line["check"]]
    assert result["frame_baseline"]["fps"] > 0
    for key in keys[1:4]:
        assert set(result[key]) == {"fps", "tex_approx_taps"} and result[key]["fps"] > 0
        assert result[key]["tex_approx_taps"] >= 0
    census = result["env_census"]
    assert {"tile_total", "recommended"} <= set(census) and rec >= census["tile_total"]["max"]
    for key in env_keys:
        assert set(result[key]) == {"fps", "env_approx_taps"} and result[key]["fps"] > 0
    # the full staging budget covers every tap; the recommended one too
    assert result["env_budget_full"]["env_approx_taps"] == 0
    assert result[f"env_budget_{rec}"]["env_approx_taps"] == 0


def test_checklist_rpc_split(tree, capsys):
    result = checklist.main(["--asset-root", str(tree), *SMALL, "--only", "rpc"])
    assert list(result) == ["rpc"]
    assert set(result["rpc"]) == {"exec_only_ms", "with_upload_ms", "full_render_ms"}
    assert all(v > 0 for v in result["rpc"].values())
    assert [line["check"] for line in _lines(capsys)] == ["rpc", "ALL"]


def test_checklist_needs_an_asset_tree_and_known_checks(tmp_path, capsys):
    with pytest.raises(SystemExit):
        checklist.main(["--asset-root", str(tmp_path / "absent"), *SMALL])
    assert "--asset-root must name an asset tree" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        checklist.main(["--asset-root", str(tmp_path), *SMALL, "--only", "dyncover"])
    assert "kernel B has one form" in capsys.readouterr().err
