"""The row-band cells: one frame in horizontal bands over NCCL ranks, one
rank a card (`parallel/frame_sharded`), each band frame one captured CUDA
graph with its collectives, the bands gathered into the whole frame.

`run` spawns the ranks with the port's `frame_sharded.launch` and returns
the cell's result from rank 0: the window's frames go back to back on every
rank (each rank lets the card queue IN_FLIGHT frames), the gathered frame
is delivered on rank 0, and rank 0 checks a seeded sample of the gathered
frames against the plain reference once every rank has freed its state.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import cells, run as harness
from benchmark.scenes import stress

COUNT_FRAMES = 4    # frames timed to size the window's fixed frame count


def run(cl: dict, seed: int, seconds: float, trace: bool, control: bool = False,
        device: str = "cuda", fault: str | None = None) -> dict:
    from direct12pbrrenderer_tpu_torch.parallel import frame_sharded

    n = cl["config"]["layout"]["ranks"]
    started = time.time() - (time.monotonic() - harness.T0)   # this process's start
    out = frame_sharded.launch(n, rank_main, cl, seed, seconds, trace, control, fault, started,
                               device=device)
    res = out[0]
    res["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in out)
    if trace:
        res["record"]["busy_s"] = float(np.mean([r["busy_s"] for r in out]))
        res["record"]["window_s"] = float(np.mean([r["window_s"] for r in out]))
    return res


def rank_main(mesh, cl, seed, seconds, trace, control, fault, started):
    import torch
    import torch.distributed as dist

    from benchmark import program
    from benchmark import trace as tr
    from benchmark.reference.frame import Reference
    from direct12pbrrenderer_tpu_torch.parallel import frame_sharded as fs
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import eager

    cfg, traffic = cl["config"], cl["traffic"]
    cuda = mesh.device.type == "cuda"
    lead = mesh.rank == 0

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.device)

    period, dt = traffic["period"], traffic["delta_time"]
    data = stress.build(cfg["scene"], seed)
    t = time.perf_counter()
    pipe = program.pipeline(cfg, program.port_scene(data), mesh.device)
    sync()
    rec = {"init_s": time.perf_counter() - t}
    cams = [program.camera(cfg, cells.pose(traffic, seed, k)) for k in range(period)]
    frame = fs.build_sharded_frame(mesh, pipe)
    state = {"avg": torch.zeros((), dtype=torch.float32, device=mesh.device)}

    def step(k):
        band, avg = frame(*fs.frame_args(pipe, cams[k % period], state["avg"], dt))
        if fault == "stale_carry":
            avg = torch.zeros_like(avg)
        if fault == "no_exchange":
            whole = band.new_zeros((mesh.size * band.shape[0],) + tuple(band.shape[1:]))
            whole[mesh.rank * band.shape[0]:(mesh.rank + 1) * band.shape[0]] = band
        else:
            whole = fs.gather_rows(mesh, band)
        if fault == "half_rows":
            whole = whole.clone()
            whole[whole.shape[0] // 2:] = 0
        elif fault == "altered":
            whole = whole.clone()
            whole[:16, :16] = 255 - whole[:16, :16]
        state["avg"] = avg
        return whole

    t = time.perf_counter()
    step(0)
    sync()
    rec["capture_s"] = time.perf_counter() - t
    k = 1
    t = time.perf_counter()
    for _ in range(COUNT_FRAMES):
        step(k)
        k += 1
    sync()
    # every rank runs the same number of frames: rank 0's estimate, shared
    per = (time.perf_counter() - t) / COUNT_FRAMES
    count = torch.tensor([max(1, int(round(seconds / per)))], device=mesh.device)
    dist.broadcast(count, 0, group=mesh.group)
    frames = int(count.item())
    picks = sorted(np.random.default_rng(seed).choice(frames, min(harness.CHECK_FRAMES, frames),
                                                      replace=False).tolist())
    kept, carries = {}, [state["avg"].clone()]
    setup_s = time.time() - started
    events = []
    sync()
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    t0 = time.perf_counter()
    for i in range(frames):
        if cuda and len(events) >= harness.IN_FLIGHT:
            events[-harness.IN_FLIGHT].synchronize()
        whole = step(k + i)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        carries.append(state["avg"])
        if lead and i in picks:
            kept[i] = whole
    sync()
    wall = time.perf_counter() - t0
    k0, k = k, k + frames
    if cuda:
        marks = [start] + events
        deliveries = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        deliveries = [wall * 1e3 / frames] * frames
    res = {"attempted": frames, "setup_s": setup_s, "band_frame_ms": wall * 1e3 / frames,
           "frame_p95_ms": float(np.percentile(deliveries, 95)),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(mesh.device)) if cuda else 0}

    # the loss counters of every pose of the path, each band's summed over
    # the ranks: a band frame reports no visible-light counts
    stats_frame = fs.build_sharded_frame(mesh, pipe, collect_stats=True)
    losses = ("bin_overflow", "tex_approx_taps", "env_approx_taps", "light_tile_overflow")
    lost = torch.zeros((period, len(losses)), dtype=torch.int64, device=mesh.device)
    with eager():
        for q in range(period):
            _, _, counts, tex, trunc, env = stats_frame(*fs.frame_args(pipe, cams[q], 0.0, dt))
            s = pipe._stats(counts.cpu().numpy(), np.array([1, 0]), int(tex), int(env),
                            int(trunc))
            lost[q] = torch.tensor([getattr(s, k) for k in losses])
    dist.all_reduce(lost, group=mesh.group)
    stats = {q: dict(zip(losses, row)) for q, row in enumerate(lost.cpu().tolist())}
    lossy = [any(s.values()) for s in stats.values()]
    if fault == "counters":
        stats = {q: {k: v + 1 for k, v in s.items()} for q, s in stats.items()}
    res["failed"] = sum(lossy[(k0 + i) % period] for i in range(frames))
    res["lossy_poses"] = sum(lossy)

    if trace:
        rec.update(traced(mesh, step, k, tr))
        res["busy_s"], res["window_s"] = rec["busy_s"], rec["window_s"]
    got = {i: f.cpu().numpy() for i, f in kept.items()}
    carry = [float(c) for c in carries]
    del pipe, frame, stats_frame, cams, kept, carries, state, whole
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier(group=mesh.group)
    if not lead:
        return {k_: res[k_] for k_ in ("memory_peak_bytes",)} | (
            {"busy_s": res["busy_s"], "window_s": res["window_s"]} if trace else {})
    ref_cfg = {**cfg["render"], **cfg["pipeline"], "fov": program.fov(cfg["render"])}
    harness.check(res, got, carry, Reference(data, ref_cfg, mesh.device),
                  Reference(data, ref_cfg, mesh.device, dtype=torch.bfloat16)
                  if control else None, traffic, seed, k0, dt, stats)
    res["record"] = rec
    return res


def traced(mesh, step, k, tr):
    """Per-layer record of harness.TRACE_FRAMES band frames on this rank
    under torch.profiler: busy and wall seconds, NCCL kernels' device ms a
    frame, breakdown."""
    import torch

    state = {"k": k}

    def loop():
        for _ in range(harness.TRACE_FRAMES):
            with torch.profiler.record_function("host.frame"):
                step(state["k"])
            state["k"] += 1

    acts, host, wall = tr.profiled(loop, ("host.frame",))
    nccl = sum(a.end - a.start for a in acts if "nccl" in a.name.lower())
    return {"busy_s": tr.busy_us(acts) / 1e6, "window_s": wall,
            "collective_ms": nccl / 1e3 / harness.TRACE_FRAMES,
            "breakdown": {"device_ops": tr.top_ops(acts), "idle_gaps": tr.idle_gaps(acts, host)}}
