"""The frame tracer (`utils/trace.py`) on the CPU, where a mark reads the
host clock into the same ring a card's mark kernel writes.

* The span tree and the marks' order of a traced frame on the plain, fused,
  planar and anisotropic tiny-pipeline paths: the ten passes and `stats` at
  depth 1, the five GBuffer stages under GBuffer, the anisotropic
  sampler's footprint and taps, or the planar texture cache's kernel E
  (`gbuffer.atlas_resolve`), under its resolve, `shade.env_plan` under
  DeferredShading where the env cache runs; the five GBuffer stages make
  up the GBuffer pass to within its first mark.
* Frames, exposure carry and FrameStats are bit-equal with tracing on and
  off, on each path.
* Tracing off leaves no recorder and opens no `record_function`.
* The ring keeps the last `ring_frames` frames as it wraps.
* Seams are named by the innermost host span open at their start, on a
  calibrated clock; `caller` where none was; `export_chrome` writes both
  tracks.
* The plans' counters in a traced frame's FrameStats equal the plans' own
  outputs, and on the anisotropic path `tex_taps` is its four trilinear
  taps a sampled slot of a covered pixel; an untraced frame's are 0.
* `start_trace` and `stop_trace` each change the captured frame's key.
* On two gloo ranks the band frame records `band.exchange` around every
  collective, `gather_rows`' after the frame in the same row, and its
  frames equal the untraced ones.
"""

import copy
import json
import math

import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.ops import envcache, gbuffer, texcache
from direct12pbrrenderer_tpu_torch.parallel import frame_sharded
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.scene.camera import Camera
from direct12pbrrenderer_tpu_torch.tools.stress_scene import build_stress_scene
from direct12pbrrenderer_tpu_torch.tools.tiny_scene import tiny_pipeline
from direct12pbrrenderer_tpu_torch.utils import trace

torch.set_num_threads(2)

PATHS = {
    "plain": dict(),
    "fused": dict(width=256, tile_h=24, tile_w=128, use_pallas=True, use_tex_kernel=True),
    "planar": dict(use_pallas=True, use_tex_kernel=True),
    "aniso": dict(use_pallas=True, use_tex_kernel=True, texture_filter="anisotropic"),
}
PASSES = ("Cull", "GBuffer", "Clustered", "DeferredShading", "Skybox", "Bloom", "AutoExposure",
          "ToneMapping", "Present")
GBUFFER = ("gbuffer.geometry", "gbuffer.binning", "gbuffer.raster", "gbuffer.tex_plan",
           "gbuffer.tex_resolve")
ANISO = ("gbuffer.aniso_footprint", "gbuffer.aniso_taps")
# the spans each path records inside gbuffer.tex_resolve
RESOLVE = {"planar": ("gbuffer.atlas_resolve",), "aniso": ANISO}


def _traced(pipe, cam, frames, ring_frames=64):
    pipe.start_trace(ring_frames=ring_frames)
    out = [pipe.render(cam) for _ in range(frames)]
    return out, pipe.stop_trace()


def _tree(frame):
    """[(name, depth, parent name)] of a traced frame's spans, in order."""
    spans = frame.spans
    return [(name, depth, None if parent is None else spans[parent][0])
            for name, _, _, parent, depth in spans]


@pytest.mark.parametrize("path", list(PATHS))
def test_span_tree_and_mark_order(path):
    pipe, cam, _ = tiny_pipeline("cpu", **PATHS[path])
    _, tr = _traced(pipe, cam, 2)
    frame = tr.frames[-1]
    env = path != "plain"
    inner = RESOLVE.get(path, ())
    want = ([("frame", 0, None)] + [("Cull", 1, "frame"), ("GBuffer", 1, "frame")]
            + [(s, 2, "GBuffer") for s in GBUFFER]
            + [(s, 3, "gbuffer.tex_resolve") for s in inner]
            + [("Clustered", 1, "frame"), ("DeferredShading", 1, "frame")]
            + ([("shade.env_plan", 2, "DeferredShading")] if env else [])
            + [(p, 1, "frame") for p in PASSES[4:]] + [("stats", 1, "frame")])
    assert _tree(frame) == want
    marks = list(frame.signature[1])
    assert marks == (["frame", "Cull", "GBuffer", *GBUFFER]
                     + [m for s in inner for m in (s, "/" + s)]
                     + ["Clustered", "DeferredShading"]
                     + (["shade.env_plan", "/shade.env_plan"] if env else [])
                     + list(PASSES[4:]) + ["stats", "end"])
    assert len(marks) <= trace.MAX_MARKS
    t = {name: (t0, t1) for name, t0, t1, _, _ in frame.spans}
    assert t["frame"] == (frame.first_ns, frame.last_ns)
    # adjacent spans share their mark; the stages tile the GBuffer pass
    # from its second mark on
    assert t["gbuffer.geometry"][0] >= t["GBuffer"][0]
    assert t["gbuffer.tex_resolve"][1] == t["GBuffer"][1] == t["Clustered"][0]
    for a, b in zip(GBUFFER, GBUFFER[1:]):
        assert t[a][1] == t[b][0]
    # the anisotropic sampler's phases, or kernel E, lie in order inside
    # the resolve
    lo = t["gbuffer.tex_resolve"][0]
    for s in inner:
        assert lo <= t[s][0] <= t[s][1] <= t["gbuffer.tex_resolve"][1]
        lo = t[s][1]
    ms = frame.ms()
    assert sum(ms[s] for s in GBUFFER) <= ms["GBuffer"]
    assert all(v >= 0 for v in ms.values())


@pytest.mark.parametrize("path", list(PATHS))
def test_frames_and_exposure_are_bit_equal_traced(path):
    pipe, cam, _ = tiny_pipeline("cpu", **PATHS[path])
    cams = []
    for k in range(3):
        c = copy.deepcopy(cam)
        c.move([0.1 * k, 0, 0])
        c.rotate(0, 0.05 * k, 0)
        cams.append(c)
    want, stats = [], []
    for c in cams:
        want.append((pipe.render(c), pipe.avg_luminance.clone()))
        stats.append(pipe.last_stats)
    pipe.avg_luminance = torch.zeros(())
    pipe.start_trace()
    for (img, avg), st, c in zip(want, stats, cams):
        assert torch.equal(pipe.render(c), img) and torch.equal(pipe.avg_luminance, avg)
        assert pipe.last_stats == st
    assert len(pipe.stop_trace().frames) == 3


def test_tracing_off_records_nothing(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counted(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    pipe, cam, _ = tiny_pipeline("cpu", **PATHS["fused"])
    pipe.render(cam)
    assert pipe.tracer is None and trace._LOCAL.rec is None and opened == []
    _, tr = _traced(pipe, cam, 1)
    assert "render" in opened and tr.host
    opened.clear()
    pipe.render(cam)
    assert opened == [] and trace._LOCAL.rec is None


def test_ring_wraps_to_its_last_frames():
    pipe, cam, _ = tiny_pipeline("cpu")
    _, tr = _traced(pipe, cam, 7, ring_frames=3)
    assert [f.seq for f in tr.frames] == [5, 6, 7]
    assert len(tr.steady()) == 3 and len(tr.seams) == 2
    assert len([h for h in tr.host if h[0] == "render"]) == 7
    assert [h[4] for h in tr.host if h[0] == "render"] == list(range(7))


def test_seams_are_named_on_the_calibrated_clock(monkeypatch, tmp_path):
    """Three frames whose marks read device times 1e6 ns off the host's:
    the calibration brings them onto the host spans, which name the seams
    (innermost open span; `caller` where none is open)."""
    tr = trace.Tracer("cpu", ring_frames=8)
    off = 10 ** 6
    ticks = iter(range(0, 10 ** 9, 1000))
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(ticks) + off)
    for k in range(3):
        trace.begin_frame(tr)
        trace.stage("Cull", 1)
        trace.finish_frame()
    monkeypatch.setattr(tr, "calibrate", lambda: (off, 7))
    # the frames' marks: 0..2000, 3000..5000, 6000..8000 after calibration;
    # seam 1 starts at 2000, seam 2 at 5000
    tr.host_spans = [["render", 1500, 2600, None, 0], ["render.clone", 1900, 2100, 0, 0],
                     ["render", 5200, 5600, None, 1]]
    got = tr.read()
    assert [(f.first_ns, f.last_ns) for f in got.frames] == [(0, 2000), (3000, 5000),
                                                             (6000, 8000)]
    assert got.seams == [(1, 1000 / 1e6, "render.clone"), (2, 1000 / 1e6, trace.CALLER)]
    assert got.calibration_error_ns == 7
    s = got.summary()
    assert s["frames"] == 3 and s["seams"] == {"render.clone": 1, trace.CALLER: 1}
    assert s["device"]["frame"] == pytest.approx(2000 / 1e6)
    path = tmp_path / "t.json"
    got.export_chrome(path)
    events = json.loads(path.read_text())["traceEvents"]
    assert {e["pid"] for e in events if e["ph"] == "X"} == {0, 1}
    assert [e["tid"] for e in events if e["name"] == "render.clone"] == [1]


def _textured_pipeline(**knobs):
    cfg = RenderConfig(256, 96, max_instances=2)
    scene = build_stress_scene(16, 8)
    for sm in scene.models:
        for mat in sm.model.materials:
            mat.set_parameter("UseAlbedoMap", True)
    pipe = DeferredRenderPipeline(scene, cfg, device="cpu", **dict(dict(
        tile_h=24, tile_w=128, bin_cap=512, atlas_max_dim=64, prefilter_size=16, brdf_lut_size=32,
        use_pallas=True, use_tex_kernel=True), **knobs))
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    return pipe, cam


@pytest.mark.parametrize("knobs", [{}, dict(tile_w=64, tile_h=12),
                                   dict(texture_filter="anisotropic")],
                         ids=["fused", "planar", "aniso"])
def test_plan_counters_are_the_plans_own(knobs, monkeypatch):
    pipe, cam = _textured_pipeline(**knobs)
    seen = {"tex": [], "env": []}
    plan, env_plan = texcache._plan_and_stage, envcache.plan_env_tiled
    shade = gbuffer._shade_from_interp

    def aniso_spy(interp, matrow, mask, *args, **kw):
        # the anisotropic sampler plans nothing: its taps are the sampled
        # slots (the material's use flags) at covered pixels, four each
        use = matrow[..., 6:11] > 0.5
        seen["tex"].append((gbuffer.ANISO_TAPS * int((use & mask[..., None]).sum()), 0))
        return shade(interp, matrow, mask, *args, **kw)

    def tex_spy(*args, **kw):
        out = plan(*args, **kw)
        cnts = out[1][:, :-1] if kw.get("cascade") else out[1]   # less the cascade flag
        seen["tex"].append((int(args[5].sum()), int(cnts.sum())))
        return out

    def env_spy(atlas, tex_t, mip_t, u_t, v_t, act_t, **kw):
        out = env_plan(atlas, tex_t, mip_t, u_t, v_t, act_t, **kw)
        seen["env"].append((int(act_t.sum()), int(out[1].sum())))
        return out

    monkeypatch.setattr(texcache, "_plan_and_stage", tex_spy)
    monkeypatch.setattr(envcache, "plan_env_tiled", env_spy)
    if knobs.get("texture_filter") == "anisotropic":
        monkeypatch.setattr(gbuffer, "_shade_from_interp", aniso_spy)
    pipe.render(cam)
    # an untraced frame counts nothing; a traced one counts the plan's work
    assert (pipe.last_stats.tex_taps, pipe.last_stats.env_taps) == (0, 0)
    seen = {"tex": [], "env": []}
    pipe.start_trace()
    pipe.render(cam)
    pipe.stop_trace()
    st = pipe.last_stats
    (tex_taps, tex_pages), = seen["tex"]
    (env_taps, env_pages), = seen["env"]
    assert tex_taps > 0 and env_taps > 0
    assert (st.tex_taps, st.tex_pages_staged, st.env_taps, st.env_pages_staged) == (
        tex_taps, tex_pages, env_taps, env_pages)
    assert st.tex_approx_taps <= st.tex_taps and st.env_approx_taps <= st.env_taps


def test_start_and_stop_trace_change_the_graph_key():
    pipe, cam, _ = tiny_pipeline("cpu", **PATHS["fused"])
    off = pipe._graph_key()
    pipe.start_trace()
    on = pipe._graph_key()
    pipe.render(cam)
    pipe.stop_trace()
    assert len({off, on}) == 2 and pipe._graph_key() == off and pipe.tracer is None
    pipe.start_trace()
    assert pipe._graph_key() not in (off, on)   # a new tracer, a new ring: a new capture
    pipe.stop_trace()
    with pytest.raises(RuntimeError):
        pipe.stop_trace()


def _band_rank(mesh):
    pipe, cam, _ = tiny_pipeline(mesh.device, width=128, height=64, tile_h=8, tile_w=128,
                                 bin_cap=256, use_pallas=True, use_tex_kernel=True)
    frame = frame_sharded.build_sharded_frame(mesh, pipe)

    def run():
        out, avg = [], torch.zeros(())
        for _ in range(3):
            band, avg = frame(*frame_sharded.frame_args(pipe, cam, avg))
            out.append(frame_sharded.gather_rows(mesh, band))
        return out

    want = run()
    pipe.start_trace()
    got = run()
    tr = pipe.stop_trace()
    last = tr.frames[-1]
    exchange = [(parent if parent is None else last.spans[parent][0], depth)
                for name, _, _, parent, depth in last.spans if name == "band.exchange"]
    return dict(equal=all(torch.equal(a, b) for a, b in zip(got, want)),
                frames=len(tr.frames), exchange=exchange,
                ms=tr.summary()["device"].get("band.exchange", 0.0),
                stages=[s[0] for s in last.spans if s[4] == 1])


def test_band_frame_traces_its_exchange_on_two_gloo_ranks():
    for out in frame_sharded.launch(2, _band_rank, device="cpu"):
        assert out["equal"] and out["frames"] == 3 and out["ms"] > 0
        # bloom's levels, the exposure sums, then gather_rows after the frame
        assert out["exchange"][-2:] == [("AutoExposure", 2), (None, 1)]
        assert {p for p, _ in out["exchange"][:-2]} == {"Bloom"}
        assert out["stages"] == ["Cull", "GBuffer", "Clustered", "DeferredShading", "Bloom",
                                 "AutoExposure", "ToneMapping", "band.exchange"]


def test_timer_calibration_is_exact_on_the_cpu():
    assert trace.Tracer("cpu").calibrate() == (0, 0)
    assert np.dtype(np.int64) == trace.Tracer("cpu").ring.numpy().dtype
