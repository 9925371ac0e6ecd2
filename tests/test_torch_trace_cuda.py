"""The frame tracer (`utils/trace.py`) on the card, over the captured frames
of `test_torch_frame_graph_cuda.py`'s stress terrain (the default path,
kernels A-D, the 1024-light path, A, B, C, F, G, planar-tex at a 24x160
raster tile, A, B, E, F, and the anisotropic path, A, B, F with the
software filter):

* With tracing off the captured frame launches the same device work as a
  pipeline that never traced; with it on, the same work in its order with
  the mark kernels (one a mark of the frame's layout) and the plans'
  counters among it, and the program's host spans in the same
  torch.profiler trace; off again, the untraced sequence.
* With tracing on, every replay writes one row of the ring with no host
  sync (the sync debug mode at "error"), and the frames, exposure carry
  and FrameStats are bit-equal to untraced ones.
* The card's `%globaltimer` step and the calibration's error are printed
  (`-s`) and lie under 10 us and 1 ms.
* The benchmark's `terrain_planar` deployment at 1920x1080 (the planar
  texture cache's route) launches A 1, B 4, E 1, F 1, the env plan 2 and
  the texture plan 2 a replay; traced, kernel E's span
  `gbuffer.atlas_resolve` reads device time inside `gbuffer.tex_resolve`,
  the frame is bit-equal to the untraced one and `tex_taps` is the plain
  reference's count at the pose.

Needs the card: marked `cuda`, skipped elsewhere (`python -m pytest
--noconftest tests/test_torch_trace_cuda.py -s` on a GPU machine).
"""

import pytest
import torch

from benchmark import cells, program
from benchmark import spans as bench_spans
from benchmark import trace as bench_trace
from benchmark.reference.frame import Reference
from benchmark.scenes import stress
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.utils import trace
from test_torch_frame_graph_cuda import PATHS, _path, _pipe

pytestmark = pytest.mark.cuda
TRACED = ("default", "lights1k", "planar-tex", "anisotropic")
PLANAR_SEED = 2**31 + 6007
MARK = "trace_mark_kernel"
# the program's host spans: under a profiler each is mirrored on the device
# timeline, and is left out of the device activities
HOST_SPANS = ("render", "render.pack", "render.upload", "render.replay", "render.clone",
              "render.stats", "capture")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _replay_names(pipe, cam, frames=2, host=None):
    """Device activities' names of `frames` replays under torch.profiler
    (copies and fills by kind, as the benchmark matches them); the names of
    the program's host spans in the same trace go to `host`."""
    acts, ranges, _ = bench_trace.profiled(
        lambda: [pipe.render(cam, collect_stats=False) for _ in range(frames)], HOST_SPANS)
    if host is not None:
        host.extend(a.name for a in ranges)
    return [bench_trace.kind(a.name) for a in acts]


@pytest.mark.parametrize("path", TRACED)
def test_tracing_off_keeps_the_untraced_graph(device, path):
    pipe, cam = _pipe(device, **PATHS[path][0])
    pipe.render(cam, collect_stats=False)
    before = _replay_names(pipe, cam)
    pipe.start_trace()
    pipe.render(cam, collect_stats=False)
    host = []
    traced = _replay_names(pipe, cam, host=host)
    tr = pipe.stop_trace()
    pipe.render(cam, collect_stats=False)
    after = _replay_names(pipe, cam)
    marks = len(tr.steady()[-1].signature[1])
    assert MARK not in " ".join(before) and after == before
    # traced: the untraced work in its order, the marks, and the plans'
    # counters (their zeroing and a few kernels each, a frame)
    rest = iter([n for n in traced if MARK not in n])
    assert all(n in rest for n in before)
    assert len(traced) - len(before) - 2 * marks <= 2 * (1 + 3 * len(trace.PLAN_COUNTERS))
    assert sum(MARK in n for n in traced) == 2 * marks
    # the program's host ranges and its mark kernels in one profiler trace
    assert sorted(set(host)) == ["render", "render.clone", "render.pack", "render.replay",
                                 "render.upload"]


@pytest.mark.parametrize("path", TRACED)
def test_traced_replays_fill_a_row_each_without_a_host_sync(device, path):
    pipe, cam = _pipe(device, **PATHS[path][0])
    cams = _path(cam, 8)
    want = []
    for c in cams:
        want.append((pipe.render(c), pipe.avg_luminance.clone(), pipe.last_stats))
    pipe.avg_luminance = torch.zeros((), device=device)
    pipe.start_trace(ring_frames=16)
    pipe.render(cams[0], collect_stats=False)   # the capture with the marks
    torch.cuda.synchronize()
    pipe.avg_luminance = torch.zeros((), device=device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [(pipe.render(c, collect_stats=False), pipe.avg_luminance) for c in cams]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tr = pipe.stop_trace()
    steady = tr.steady()
    assert [f.captured for f in steady] == [True] * 9
    assert [f.seq for f in steady] == list(range(steady[0].seq, steady[0].seq + 9))
    for (img, avg, _), (g, a) in zip(want, got):
        assert torch.equal(img, g) and torch.equal(avg, a)
    pipe.start_trace()
    pipe.avg_luminance = torch.zeros((), device=device)
    for (img, avg, stats), c in zip(want, cams):
        assert torch.equal(pipe.render(c), img) and pipe.last_stats == stats
    s = pipe.stop_trace().summary()
    print(f"\n[trace-cuda] {path}: " + ", ".join(f"{k} {v:.4f}" for k, v in s["device"].items())
          + f"; seams {s['seams']} mean {s['seam_ms']} ms")
    # the five GBuffer stages (the anisotropic sampler's spans nest in one)
    stages = sum(s["device"][k] for k in bench_spans.GBUFFER_STAGES)
    assert 0.9 * s["device"]["GBuffer"] <= stages <= s["device"]["GBuffer"]


def test_timer_step_and_calibration(device):
    step = trace.timer_step_ns(device)
    offset, err = trace.Tracer(device).calibrate()
    print(f"\n[trace-cuda] %globaltimer step {step} ns; calibration offset {offset} ns, "
          f"error {err} ns on {torch.cuda.get_device_name(device)}")
    assert 0 < step < 10_000 and 0 <= err < 1_000_000


def test_planar_route_at_the_benchmark_size(device):
    cl = cells.cell("terrain_planar_stream", cells.spec())
    cfg, traffic = cl["config"], cl["traffic"]
    dt = traffic["delta_time"]
    data = stress.build(cfg["scene"], PLANAR_SEED)
    pipe = program.pipeline(cfg, program.port_scene(data), device)
    assert not pipe.use_fused_gbuffer and pipe.use_tex_kernel and pipe.captured
    pose = cells.pose(traffic, PLANAR_SEED, 0)
    cam = program.camera(cfg, pose)
    carry = pipe.avg_luminance.clone()
    pipe.render(cam, dt)   # the capture
    pipe.avg_luminance = carry.clone()
    before = LAUNCHES.copy()
    want = pipe.render(cam, dt)
    launches = dict(LAUNCHES - before)
    want_stats, want_avg = pipe.last_stats, pipe.avg_luminance.clone()
    print(f"\n[trace-cuda] terrain_planar launches a replay {launches}; {want_stats}")
    assert launches == PATHS["planar-tex"][1]
    pipe.start_trace()
    pipe.avg_luminance = carry.clone()
    pipe.render(cam, dt)   # the capture with the marks
    pipe.avg_luminance = carry.clone()
    got = pipe.render(cam, dt)
    tr = pipe.stop_trace()
    assert torch.equal(got, want) and torch.equal(pipe.avg_luminance, want_avg)
    assert pipe.last_stats == want_stats
    taps = pipe.last_stats.tex_taps
    dev = tr.summary()["device"]
    print(f"[trace-cuda] terrain_planar: gbuffer.atlas_resolve {dev['gbuffer.atlas_resolve']:.4f} "
          f"ms in gbuffer.tex_resolve {dev['gbuffer.tex_resolve']:.4f} ms; tex_taps {taps}")
    assert 0 < dev["gbuffer.atlas_resolve"] < dev["gbuffer.tex_resolve"]
    del pipe
    ref = Reference(data, {**cfg["render"], **cfg["pipeline"], "fov": program.fov(cfg["render"])},
                    device)
    assert taps == ref.counts(pose)["tex_taps"] > 0
