"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's scene from the seed, sets up the port's pipeline (its
kernels build once into `build/kernels/` of this checkout, then stay
cached), renders the cell's loop for `--seconds`, checks a seeded sample of
the window's frames against the plain reference (`reference/`) and prints
one JSON line as the last line of standard output. With `--trace 1` the
line carries the cell's per-layer metrics instead of its end-to-end ones.
Needs CUDA and as many cards as the cell asks for; exits 2 without them.
"""

from __future__ import annotations

import time

T0 = time.monotonic()   # the process's start, as near as Python sees it

import argparse   # noqa: E402
import gc   # noqa: E402
import json   # noqa: E402
import os   # noqa: E402
import random   # noqa: E402
import sys   # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

import numpy as np   # noqa: E402

from benchmark import cells   # noqa: E402
from benchmark.scenes import stress   # noqa: E402

CHECK_FRAMES = 4      # window frames the reference renders, drawn from the seed
WARM_FRAMES = 3       # frames after the capture, before the window
IN_FLIGHT = 3         # frames a streamed loop lets the card queue (a swap chain's)
TRACE_FRAMES = 8      # frames of the loop the traced run profiles
FORBIDDEN = ("jax", "jaxlib", "flax", "direct12pbrrenderer_tpu")
FAULTS = ("stale_carry", "half_rows", "altered", "no_exchange", "counters")
STATS = ("visible_instances", "total_instances", "visible_lights", "bin_overflow",
         "tex_approx_taps", "env_approx_taps", "lights_truncated", "light_tile_overflow")
LOSSES = ("bin_overflow", "tex_approx_taps", "env_approx_taps", "lights_truncated",
          "light_tile_overflow")


class NoDevice(RuntimeError):
    pass


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's (the port's name begins with the last and is allowed)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Sample:
    """A uniform sample of `k` window frames, drawn from the seed as they
    come (reservoir sampling), so any frame of the window may be checked."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed * 7919 + 17), {}

    def offer(self, i: int, frame) -> None:
        if i < self.k:
            self.items[i] = frame
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            del self.items[sorted(self.items)[j]]
            self.items[i] = frame


def rmse8(a: np.ndarray, b: np.ndarray) -> float:
    d = (a.astype(np.float64) - b.astype(np.float64)) / 255.0
    return float(np.sqrt(np.mean(d * d)))


def run_single(cl: dict, seed: int, seconds: float, trace: bool, device: str,
               fault: str | None = None, control: bool = False) -> dict:
    """One run of a one-card cell; returns the result dict (without the
    `checks`' verdict applied)."""
    import torch

    from benchmark import program
    from benchmark.reference.frame import Reference

    cfg, traffic = cl["config"], cl["traffic"]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    interactive = traffic["loop"] == "interactive"
    period, dt = traffic["period"], traffic["delta_time"]
    data = stress.build(cfg["scene"], seed)
    override = {}
    if control and cfg.get("control") == "program_bf16":
        override["fused_light_dtype"] = "bfloat16"
    t = time.perf_counter()
    scene = program.port_scene(data)
    pipe = program.pipeline(cfg, scene, device, **override)
    sync()
    rec = {"init_s": time.perf_counter() - t}
    poses = [cells.pose(traffic, seed, k) for k in range(period)]
    cams = [program.camera(cfg, p) for p in poses]
    carry0 = pipe.avg_luminance.clone()

    def render(k):
        out = pipe.render(cams[k % period], dt, collect_stats=False)
        if fault == "stale_carry":
            pipe.avg_luminance = carry0.clone()
        elif fault == "half_rows":
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        elif fault == "altered":
            out = out.clone()
            out[:16, :16] = 255 - out[:16, :16]
        return out

    t = time.perf_counter()
    first = render(0)
    if interactive:
        first.cpu()
    sync()
    rec["capture_s"] = time.perf_counter() - t
    for k in range(1, 1 + WARM_FRAMES):
        out = render(k)
        if interactive:
            out.cpu()
    sync()
    k0 = 1 + WARM_FRAMES
    sample = Sample(CHECK_FRAMES, seed)
    carries, host_ms, deliveries = [pipe.avg_luminance.clone()], [], []
    setup_s = time.monotonic() - T0
    t0 = time.perf_counter()
    n = 0
    if interactive:
        last = t0
        while time.perf_counter() - t0 < seconds:
            th = time.perf_counter()
            out = render(k0 + n)
            host_ms.append((time.perf_counter() - th) * 1e3)
            img = out.cpu().numpy()
            now = time.perf_counter()
            deliveries.append((now - last) * 1e3)
            last = now
            carries.append(pipe.avg_luminance.clone())
            sample.offer(n, img)
            n += 1
        wall = last - t0
    else:
        events = []
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        if cuda:
            start.record()
        while time.perf_counter() - t0 < seconds:
            if len(events) >= IN_FLIGHT and cuda:
                events[-IN_FLIGHT].synchronize()
            th = time.perf_counter()
            out = render(k0 + n)
            host_ms.append((time.perf_counter() - th) * 1e3)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            else:
                deliveries.append(time.perf_counter())
            carries.append(pipe.avg_luminance.clone())
            sample.offer(n, out)
            n += 1
        sync()
        wall = time.perf_counter() - t0
        if cuda:
            marks = [start] + events
            deliveries = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            deliveries = list(np.diff([t0] + deliveries) * 1e3)
    half = max(1, n // 2)
    print(f"[window] {n} frames in {wall:.3f} s; delivery ms: mean of the first half "
          f"{np.mean(deliveries[:half]):.4f}, of the rest {np.mean(deliveries[-half:]):.4f}, "
          f"min {np.min(deliveries):.4f}, p50 {np.median(deliveries):.4f}, "
          f"max {np.max(deliveries):.4f}", file=sys.stderr)
    res = {"attempted": n, "setup_s": setup_s,
           "frame_ms": wall * 1e3 / n, "frame_p95_ms": float(np.percentile(deliveries, 95))}
    rec["render_host_ms"] = float(np.mean(host_ms))
    res["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if cuda else 0

    # the counters of every pose of the path: one period rendered with them
    # read back; a pose that loses work fails each window frame at it
    stats = {}
    for q in range(period):
        pipe.render(cams[q], dt, collect_stats=True)
        stats[q] = {k: getattr(pipe.last_stats, k) for k in STATS}
    lossy = [any(stats[q][k] for k in LOSSES) for q in range(period)]
    if fault == "counters":
        stats = {q: {k: v + 1 for k, v in s.items()} for q, s in stats.items()}
    res["failed"] = sum(lossy[(k0 + i) % period] for i in range(n))
    res["lossy_poses"] = sum(lossy)

    if trace:
        rec.update(traced(pipe, cams, period, dt, k0 + n, interactive))

    frames = {i: (f.cpu().numpy() if hasattr(f, "cpu") else f) for i, f in sample.items.items()}
    carry = [float(c) for c in carries]
    del pipe, scene, cams, first, out, sample, carries
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref_cfg = {**cfg["render"], **cfg["pipeline"], "fov": program.fov(cfg["render"])}
    ctl = (Reference(data, ref_cfg, device, dtype=torch.bfloat16)
           if control and cfg.get("control") == "reference_bf16" else None)
    ref = Reference(data, ref_cfg, device)
    check(res, frames, carry, ref, ctl, traffic, seed, k0, dt, stats)
    if trace:
        first_pose = cells.pose(traffic, seed, rec.pop("trace_start"))
        rec["counts"] = ref.counts(first_pose)
        print(f"[counts] {rec['counts']} at the first traced pose; kernel ms a replay "
              f"{rec['kernel_ms']}", file=sys.stderr)
    res["record"] = rec
    return res


def check(res: dict, frames: dict, carry: list, ref, ctl, traffic: dict, seed: int, k0: int,
          dt: float, stats: dict) -> None:
    """Hold each sampled window frame i (window frame i is path frame
    k0 + i) to the reference rendered at its pose from the exposure carry
    the program left before it (`carry[i]`), and the program's carry after
    it (`carry[i + 1]`) to the reference's EMA step. With `ctl`, that
    reference (in bfloat16) stands in the program's place. `stats` holds
    the program's counters at each pose q of the path (pose q is path frame
    q), those its path reports; each is held to the reference's. Sets
    res["checks"] and, for the log, res["check_detail"]."""
    off2, off1, gap, detail = 0.0, 0.0, 0.0, {}
    for i, img in sorted(frames.items()):
        p = cells.pose(traffic, seed, k0 + i)
        want, avg, _ = ref.render(p, carry[i], dt)
        want = want.cpu().numpy()
        got = carry[i + 1]
        if ctl is not None:
            img, got_t, _ = ctl.render(p, carry[i], dt)
            img, got = img.cpu().numpy(), float(got_t)
        d = np.abs(img.astype(np.int32) - want.astype(np.int32))
        g = abs(got - float(avg)) / max(abs(float(avg)), 1e-30)
        off2, off1 = max(off2, float((d >= 2).mean())), max(off1, float((d >= 1).mean()))
        gap = max(gap, g)
        detail[i] = [rmse8(img, want), g] + np.bincount(np.minimum(d, 4).ravel(),
                                                        minlength=5).tolist()
    wrong = []
    for q, got in sorted(stats.items()):
        want = ref.stats(cells.pose(traffic, seed, q))
        wrong += [(q, k, v, want[k]) for k, v in got.items() if v != want[k]]
    res["checks"] = {"off2_share": off2, "off1_share": off1, "carry_gap": gap,
                     "stats_off": len(wrong)}
    res["check_detail"] = detail
    res["stats_detail"] = wrong[:8]


def traced(pipe, cams, period, dt, k, interactive):
    """Per-layer record of TRACE_FRAMES frames of the cell's loop under
    torch.profiler: device busy and wall seconds, per-pass device ms of the
    replays (attributed from an eager frame), kernel ms, breakdown."""
    import torch

    from benchmark import trace as tr
    from direct12pbrrenderer_tpu_torch.graph import frame_graph as fg
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import eager

    state = {"k": k}

    def loop():
        for _ in range(TRACE_FRAMES):
            with torch.profiler.record_function("host.render"):
                out = pipe.render(cams[state["k"] % period], dt, collect_stats=False)
            if interactive:
                with torch.profiler.record_function("host.read"):
                    out.cpu()
            state["k"] += 1

    graph = pipe.graph
    names = [p.name for p in graph.order]

    def wrap(p, last):
        def fn(env):
            torch.cuda._sleep(1)
            out = p.fn(env)
            if last:
                torch.cuda._sleep(1)
            return out
        return fg.RenderPass(p.name, p.reads, p.writes, fn, p.declares)

    def eager_frame():
        # the counters' gathering after the last pass is in the captured
        # graph too, so the eager frame collects them
        pipe.graph = fg.CompiledGraph(
            [wrap(p, i == len(names) - 1) for i, p in enumerate(graph.order)],
            graph.lifetimes, graph.donatable, graph.descriptions)
        try:
            with eager():
                pipe.render(cams[state["k"] % period], dt, collect_stats=True)
        finally:
            pipe.graph = graph

    last_err = None
    for _ in range(tr.TRACE_TRIES):
        ev, _, _ = tr.profiled(eager_frame)
        try:
            passes = tr.split_passes(ev, names)
        except tr.AttributionError as e:
            last_err = e
            continue
        start = state["k"]
        acts, host, wall = tr.profiled(loop, ("host.render", "host.read"))
        try:
            frames = tr.match_replays(acts, passes, TRACE_FRAMES)
        except tr.AttributionError as e:
            last_err = e
            continue
        break
    else:
        raise tr.AttributionError(f"no trace attributed in {tr.TRACE_TRIES} tries: {last_err}")
    busy = tr.busy_us(acts) / 1e6
    pass_ms = {p: sum(tr.busy_us(f[p]) for f in frames) / 1e3 / len(frames) for p in passes}
    frame_busy = sum(tr.busy_us([a for lst in f.values() for a in lst]) for f in frames)
    kernel_ms = {}
    for name in ("deferred_shade_kernel", "point_lights_kernel"):
        us = sum(a.end - a.start for f in frames for lst in f.values() for a in lst
                 if name in a.name)
        if us:
            kernel_ms[name] = us / 1e3 / len(frames)
    print(f"[trace] passes sum {sum(pass_ms.values()):.4f} ms vs replay busy "
          f"{frame_busy / 1e3 / len(frames):.4f} ms a frame, window busy "
          f"{busy * 1e3 / TRACE_FRAMES:.4f} ms a frame; " +
          ", ".join(f"{p} {v:.4f}" for p, v in pass_ms.items()), file=sys.stderr)
    # the traced loop ran its warm-up cycle first: it started TRACE_FRAMES later
    return {"busy_s": busy, "window_s": wall, "pass_ms": pass_ms, "kernel_ms": kernel_ms,
            "trace_start": start + TRACE_FRAMES,
            "breakdown": {"device_ops": tr.top_ops(acts), "idle_gaps": tr.idle_gaps(acts, host)}}


def device_info(n: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the cell's lower-precision control in the program's place")
    ap.add_argument("--fault", choices=FAULTS,
                    help="break the timed path underneath (to read what the check gives)")
    args = ap.parse_args(argv)
    cl = cells.cell(args.workload, cells.spec())
    chips = cl["workload"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cl["traffic"]["loop"] == "bands":
        from benchmark import bands
        res = bands.run(cl, args.seed, args.seconds, bool(args.trace), control=args.control,
                        fault=args.fault)
    else:
        res = run_single(cl, args.seed, args.seconds, bool(args.trace), "cuda",
                         fault=args.fault, control=args.control)
    return report(cl, res, bool(args.trace), device_info(chips))


def report(cl: dict, res: dict, trace: bool, device: dict) -> int:
    """Print the compared numbers and the result line; 1 if a forbidden
    module is loaded (then no result is printed)."""
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    # a number the configuration gives no limit is read and printed, not
    # compared: its control did not read three times the program's
    limits = cl["config"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in res["checks"].items()
              if k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in cl["end_to_end"] + cl["per_layer"]}
    if trace:
        rec = res["record"]
        metrics = {}
        for m in cl["per_layer"]:
            v = cells.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        metrics = {m["name"]: {"value": res[m["name"]], "unit": units[m["name"]]}
                   for m in cl["end_to_end"]}
    device = {**device, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = res["record"]["busy_s"]
        device["window_s"] = res["record"]["window_s"]
        line["breakdown"] = res["record"]["breakdown"]
    line["checks"] = checks
    print(f"[detail] lossy poses {res['lossy_poses']} of the period; sampled frames (index: "
          f"[rmse, carry gap, channel values off by 0, 1, 2, 3, 4+ LSB]) {res['check_detail']}; "
          f"counters off the reference's (pose, counter, program, reference) "
          f"{res['stats_detail']}", file=sys.stderr)
    for k, v in res["checks"].items():
        if k not in checks:
            print(f"{k} {v!r} (read, not compared)", file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
