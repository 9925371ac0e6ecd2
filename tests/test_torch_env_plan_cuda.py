"""The env cache's plan kernels (`csrc/env_plan.cu`, around kernel B's env
cover) on the card, held bit for bit to their plain version
`envcache.env_plan_reference` (`shading.env_tap_groups`, then
`plan_env_tiled`):

* on the 1920x1080 fields of the terrain262k cell's fused pass (tile blocks)
  and of the lights1k cell's unfused pass (the image cut into 24x128 tiles):
  every output, the staged rows included; again under a budget that
  truncates spans, and with four groups (no env content);
* a captured frame of each cell against the same frame of a pipeline whose
  plan is the plain version: image, FrameStats, exposure carry and the
  traced frame's env_taps and env_pages_staged equal; a replay adds the
  plan's two launches and kernel B's four.

Needs the card: marked `cuda`, skipped elsewhere (`python -m pytest
--noconftest tests/test_torch_env_plan_cuda.py` on a GPU machine).
"""

import gc

import pytest
import torch

from chip_smoke import (BASE_KNOBS, BRDF_LUT, ENV_PLAN_OUTPUTS, camera_path, cell_camera,
                        lights1k_cell, recording, textured_cell)
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import envcache

pytestmark = pytest.mark.cuda
CELLS = ("terrain262k", "lights1k")
TRUNCATING_BUDGET = 56   # 8 x 5 groups + 16 pages a tile


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _pipe(device, cell):
    """(pipeline, camera) of the cell at 1920x1080, as chip_smoke.py builds it."""
    if cell == "terrain262k":
        *_, pipe, cam = textured_cell(device)
        assert pipe.use_fused_deferred
        return pipe, cam
    pipe = lights1k_cell(device, dict(BASE_KNOBS, brdf_lut_size=BRDF_LUT))[3]
    assert not pipe.use_fused_deferred
    return pipe, cell_camera(pipe.config)


def _equal(got, want):
    for g, w, name in zip(got, want, ENV_PLAN_OUTPUTS):
        if isinstance(g, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), name
        else:
            assert g == w, name


@pytest.mark.parametrize("cell", CELLS)
def test_env_plan_kernels_equal_the_plain_version(device, cell):
    pipe, cam = _pipe(device, cell)
    with recording(envcache, "env_plan") as calls:
        pipe.render(cam, collect_stats=False)
        torch.cuda.synchronize()
    (args, kw), = calls
    del pipe
    assert (kw.get("tile") is None) == (cell == "terrain262k")
    env_ids = (*args[6][:4], True)
    cases = {"frame": (args, kw),
             "budget": (args[:6] + (env_ids,), dict(kw, stage_budget=TRUNCATING_BUDGET)),
             "no_env": (args[:6] + ((*env_ids[:4], False),), kw)}
    for case, (a, k) in cases.items():
        launches = LAUNCHES["env_plan"]
        got = envcache.env_plan(*a, **k)
        assert LAUNCHES["env_plan"] == launches + 2, case
        want = envcache.env_plan_reference(*a, **k)
        _equal(got, want)
        assert got[3].shape[1] == (4 if case == "no_env" else 5), case
        if case == "budget":      # the budget really truncated spans
            assert int(got[7]) > 0 and got[2].shape[1] == TRUNCATING_BUDGET * 8
        elif case == "frame":     # the cells' frames leave no tap to the fallback
            assert int(got[7]) == 0 and got[6].any()
        del got, want


@pytest.mark.parametrize("cell", CELLS)
def test_captured_frames_equal_frames_of_the_plain_plan(device, cell, monkeypatch):
    def render_plain(c):              # its captures take the plain plan
        with monkeypatch.context() as m:
            m.setattr(envcache, "env_plan", envcache.env_plan_reference)
            return plain.render(c)

    kern, cam = _pipe(device, cell)
    kern.render(cam)                  # the capture, with the plan's kernels
    plain, _ = _pipe(device, cell)
    render_plain(cam)
    plain.avg_luminance = kern.avg_luminance.clone()
    for c in camera_path(cam, 3):
        before = (LAUNCHES["env_plan"], LAUNCHES["fused_cover"])
        got = kern.render(c)
        torch.cuda.synchronize()
        assert (LAUNCHES["env_plan"] - before[0],
                LAUNCHES["fused_cover"] - before[1]) == (2, 4)
        want = render_plain(c)
        assert torch.equal(got, want)
        assert kern.last_stats == plain.last_stats
        assert torch.equal(kern.avg_luminance, plain.avg_luminance)
    counts = []
    for pipe, render in ((kern, kern.render), (plain, render_plain)):
        pipe.start_trace()            # a traced frame counts the plan's taps and pages
        render(c)
        pipe.stop_trace()
        counts.append((pipe.last_stats.env_taps, pipe.last_stats.env_pages_staged))
    assert counts[0] == counts[1] and min(counts[0]) > 0
    del kern, plain
    gc.collect()
    torch.cuda.empty_cache()
