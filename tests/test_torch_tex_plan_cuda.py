"""The texture cache's plan kernels (`csrc/tex_plan.cu`, around kernel B's
texture covers) on the card, held bit for bit to their plain version
`texcache.tex_plan_reference` (the fused path's tap setup, then
`_plan_and_stage`), on every output: offsets, counts, staged pages, records,
fracs, the trilinear frac, the covered and cascade masks and the fallback
count.

* Fused layout: the 1920x1080 terrain262k frame's raster blocks, planned as
  the cell plans them (trilinear, block caps (32, 16), no budget) and under
  the bilinear filter, the cascades (12, 8, 1) and (20, 8, 3), a truncating
  budget, one block cap of 16 and a lo cap of 156 (kernel I); its first 180
  tiles (the 288x1920 band canvas); a 64x48 frame on its padded 128x48
  canvas.
* Planar layout: synthetic taps on a stub atlas (trilinear, bilinear, a
  starved cover that cascades, an 18-row tile) and a frame of the planar
  texture-cache path.
* A captured frame of the fused and the planar path against the same frame
  of a pipeline whose plan is the plain version: image, FrameStats, exposure
  carry and the traced frame's tex_taps and tex_pages_staged equal; a replay
  adds the plan's two launches and kernel B's four.

Needs the card: marked `cuda`, skipped elsewhere (`python -m pytest
--noconftest tests/test_torch_tex_plan_cuda.py` on a GPU machine).
"""

import gc
import math

import numpy as np
import pytest
import torch

from chip_smoke import camera_path, recording, stress_scene, stub_atlas, textured_cell
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import texcache
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.scene.camera import Camera

pytestmark = pytest.mark.cuda
OUTPUTS = ("off", "cnts", "staged", "rec", "fx", "fy", "tl", "covered", "sel", "approx")
CELL_KW = dict(trilinear=True, cap_lo=92, cap_hi=44, block_cap=(32, 16), stage_budget=None,
               cascade=False)
# case -> the knobs over the cell's
FUSED = {
    "cell": {},
    "bilinear": dict(trilinear=False),
    "cascade_12_8_1": dict(cascade=True, cascade_caps=(12, 8, 1)),
    "cascade_20_8_3": dict(cascade=True, cascade_caps=(20, 8, 3)),
    "budget": dict(stage_budget=80),   # 8 pages a group: spans truncate
    "block_cap_16": dict(block_cap=16),
    "cap_156": dict(cap_lo=156),
}
# the frame-graph cells' knobs (tests/test_torch_frame_graph_cuda.py) over a
# 16,384-triangle textured terrain
KNOBS = dict(tile_h=24, tile_w=128, bin_cap=1024, atlas_max_dim=256, prefilter_size=16,
             brdf_lut_size=32, tex_caps=(92, 44, None, (32, 16)))


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _equal(got, want, case):
    assert len(got) == len(want) == len(OUTPUTS)
    for g, w, name in zip(got, want, OUTPUTS):
        if w is None:
            assert g is None, (case, name)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), (case, name)


def _check(atlas, fields, tile, kw, case):
    """The kernels against the plain version on one call: two launches of
    the plan (three with the cascade), every output equal. -> the outputs."""
    before = LAUNCHES["tex_plan"]
    got = texcache.tex_plan(atlas, fields, tile, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["tex_plan"] - before == 2 + bool(kw.get("cascade")), case
    want = texcache.tex_plan_reference(atlas, fields, tile, **kw)
    _equal(got, want, case)
    return got


def _recorded(pipe, cam):
    """(atlas, fields, tile, knobs) of the one `tex_plan` call of a frame."""
    with recording(texcache, "tex_plan") as calls:
        pipe.render(cam, collect_stats=False)
        torch.cuda.synchronize()
    (args, kw), = calls
    return args[0], args[1], args[2], kw


def _terrain_cell(device, width, height, **knobs):
    """(pipeline, camera) of the terrain at width x height, the stress cells'
    pose."""
    scene = stress_scene(128, 64, 32, 20.0)
    cfg = RenderConfig(width, height, max_instances=2)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    return DeferredRenderPipeline(scene, cfg, device=device, **dict(KNOBS, **knobs)), cam


def _planar_cell(device):
    """1024x192 at a 24x160 raster tile: the G-buffer samples through the
    planar cache (the frame-graph test's planar-tex path)."""
    pipe, cam = _terrain_cell(device, 1024, 192, tile_w=160)
    assert pipe.use_tex_kernel and not pipe.use_fused_gbuffer
    return pipe, cam


def test_fused_plan_kernels_equal_the_plain_version(device):
    *_, pipe, cam = textured_cell(device)
    atlas, fields, tile, kw = _recorded(pipe, cam)
    del pipe
    assert len(fields) == 2 and tile == (24, 128) and fields[0].shape[0] == 675
    assert {k: kw[k] for k in CELL_KW} == CELL_KW
    for case, knobs in FUSED.items():
        got = _check(atlas, fields, tile, dict(kw, **knobs), case)
        if case == "budget":       # the budget really truncated spans
            assert int(got[9]) > 0 and got[2].shape[1] == 80 * 4
        elif case == "cell":       # the cell's frame leaves no tap to the fallback
            assert int(got[9]) == 0 and got[7].any()
        elif case.startswith("cascade"):   # 15 groups and the any-cascade column
            assert got[1].shape[1] == 16
        del got
    # the 288x1920 band canvas: its 12 rows of 15 tiles
    band = tuple(x[:180] for x in fields)
    _check(atlas, band, tile, kw, "band")
    # a tile of 48 rows of 128 pixels is more than kernel B takes
    with pytest.raises(ValueError, match="kernel B"):
        texcache.tex_plan(atlas, tuple(x[:2].reshape(1, 6144, x.shape[2]) for x in fields),
                          (48, 128), **kw)


def test_padded_canvas_plan_kernels_equal_the_plain_version(device):
    pipe, cam = _terrain_cell(device, 64, 48)
    assert pipe.use_fused_gbuffer
    atlas, fields, tile, kw = _recorded(pipe, cam)
    assert fields[0].shape[:2] == (2, 3072) and tile == (24, 128)
    assert (fields[1] >= 0).any() and pipe.render_w == 128
    for case, knobs in FUSED.items():
        _check(atlas, fields, tile, dict(kw, **knobs), f"padded-{case}")


PLANAR = {
    "trilinear": (48, 256, dict(trilinear=True)),
    "bilinear": (48, 256, dict(trilinear=False)),
    "cascade": (48, 256, dict(cap_lo=4, cap_hi=4, block_cap=(4, 4), cascade=True,
                              cascade_caps=(12, 8, 1))),
    "rows_18": (36, 128, dict(cap_lo=156, block_cap=(32, 16))),
}


@pytest.mark.parametrize("name", list(PLANAR))
def test_planar_plan_kernels_equal_the_plain_version(device, name):
    h, w, kw = PLANAR[name]
    rng = np.random.default_rng(13)
    atlas = stub_atlas(rng, device)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = torch.as_tensor((xx / w * 1.4 + rng.random((h, w)) * 0.01).astype(np.float32))
    v = torch.as_tensor((yy / h * 1.1 + rng.random((h, w)) * 0.01).astype(np.float32))
    tex = torch.as_tensor(rng.integers(0, 3, (h, w, 5)).astype(np.int32))
    lod = torch.as_tensor((0.5 + rng.random((h, w, 5)) * 2.0).astype(np.float32))
    act = torch.as_tensor(rng.random((h, w, 5)) > 0.2)
    fields = tuple(x.to(device) for x in (tex, u, v, lod, act))
    got = _check(atlas, fields, texcache.pick_tile(h, w), kw, name)
    if name == "cascade":            # the starved cover really cascaded
        assert got[8].any() and int(got[9]) > 0


def test_planar_frame_plan_kernels_equal_the_plain_version(device):
    pipe, cam = _planar_cell(device)
    atlas, fields, tile, kw = _recorded(pipe, cam)
    assert len(fields) == 5 and tile != (24, 160)
    for case, knobs in FUSED.items():
        _check(atlas, fields, tile, dict(kw, **knobs), f"planar-{case}")


@pytest.mark.parametrize("path", ["fused", "planar"])
def test_captured_frames_equal_frames_of_the_plain_plan(device, path, monkeypatch):
    def build():
        if path == "fused":
            *_, pipe, cam = textured_cell(device)
            return pipe, cam
        return _planar_cell(device)

    def render_plain(c):              # its captures take the plain plan
        with monkeypatch.context() as m:
            m.setattr(texcache, "tex_plan", texcache.tex_plan_reference)
            return plain.render(c)

    kern, cam = build()
    kern.render(cam)                  # the capture, with the plan's kernels
    plain, _ = build()
    render_plain(cam)
    plain.avg_luminance = kern.avg_luminance.clone()
    for c in camera_path(cam, 3):
        before = (LAUNCHES["tex_plan"], LAUNCHES["fused_cover"])
        got = kern.render(c)
        torch.cuda.synchronize()
        assert (LAUNCHES["tex_plan"] - before[0], LAUNCHES["fused_cover"] - before[1]) == (2, 4)
        want = render_plain(c)
        assert torch.equal(got, want)
        assert kern.last_stats == plain.last_stats
        assert torch.equal(kern.avg_luminance, plain.avg_luminance)
    counts = []
    for pipe, render in ((kern, kern.render), (plain, render_plain)):
        pipe.start_trace()            # a traced frame counts the plan's taps and pages
        render(c)
        pipe.stop_trace()
        counts.append((pipe.last_stats.tex_taps, pipe.last_stats.tex_pages_staged))
    assert counts[0] == counts[1] and min(counts[0]) > 0
    del kern, plain
    gc.collect()
    torch.cuda.empty_cache()
