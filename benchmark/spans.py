"""The program's own spans in a traced run, read by the span metrics
(`metrics/geometry_ms.py`, `binning_ms.py`, `raster_ms.py`,
`tex_plan_ms.py`, `tex_resolve_ms.py`, `env_plan_ms.py`,
`frame_seam_ms.py`).

A metric reader is handed the run's record alone, after the run has
freed its pipeline. So the first span reader of a `--trace 1` run takes the
spans itself, once a process, and keeps them in the record for the
others: it builds the cell's scene and pipeline again from the run's
`--workload` and `--seed`, renders WARM_FRAMES frames of the cell's loop
untraced, turns the program's tracer on (`pipe.start_trace()`, which
captures the frame anew with its marks), renders one frame with its
counters read back (the plans' counters), then SPAN_FRAMES frames of the
same loop (streamed with IN_FLIGHT frames queued, or interactive with each
frame read back), reads the tracer out (`pipe.stop_trace()`) and prints
the named seams, the counters and the stage sums on standard error. The
seams are those between the loop's frames. A program without the tracer
(no `start_trace`), a band cell, or a process not started as `run.py
--workload ... --seed ...` reads nothing: every span metric is then None.
"""

from __future__ import annotations

import argparse
import gc
import sys

from benchmark import cells, program
from benchmark.scenes import stress

SPAN_FRAMES = 32   # traced frames of the cell's loop
WARM_FRAMES = 3    # untraced frames first: the capture and the kernel builds
IN_FLIGHT = 3      # frames a streamed loop lets the card queue (run.py's)
GBUFFER_STAGES = ("gbuffer.geometry", "gbuffer.binning", "gbuffer.raster", "gbuffer.tex_plan",
                  "gbuffer.tex_resolve")
COUNTERS = ("tex_taps", "tex_pages_staged", "env_taps", "env_pages_staged",
            "tex_approx_taps", "env_approx_taps")


def span_ms(rec: dict, name: str):
    """Mean device ms a frame of the program's span `name` (None where the
    run has no spans or the span did not run)."""
    s = spans(rec)
    return None if s is None else s["summary"]["device"].get(name)


def seam_ms(rec: dict):
    """Mean device ms from a frame's last mark to the next one's first."""
    s = spans(rec)
    return None if s is None else s["seam_ms"]


def spans(rec: dict) -> dict | None:
    if "spans" not in rec:
        rec["spans"] = take(_cell_args())
    return rec["spans"]


def _cell_args():
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    return None if args.workload is None or args.seed is None else args


def take(args) -> dict | None:
    """{"summary": `Trace.summary()`, "seams": [[name, ms]] and "seam_ms" (their
    mean) between the loop's frames, "counters", "calibration_error_ns"} of
    the traced frames, or None."""
    if args is None:
        return None
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    if not hasattr(DeferredRenderPipeline, "start_trace"):
        return None
    cl = cells.cell(args.workload, cells.spec())
    cfg, traffic = cl["config"], cl["traffic"]
    if traffic["loop"] not in ("stream", "interactive"):
        return None
    import torch

    period, dt = traffic["period"], traffic["delta_time"]
    pipe = program.pipeline(cfg, program.port_scene(stress.build(cfg["scene"], args.seed)),
                            "cuda")
    cams = [program.camera(cfg, cells.pose(traffic, args.seed, k)) for k in range(period)]
    state = {"k": 0}

    def loop(n):
        events = []
        for _ in range(n):
            if len(events) >= IN_FLIGHT:
                events[-IN_FLIGHT].synchronize()
            out = pipe.render(cams[state["k"] % period], dt, collect_stats=False)
            if traffic["loop"] == "interactive":
                out.cpu()
            else:
                ev = torch.cuda.Event()
                ev.record()
                events.append(ev)
            state["k"] += 1
        torch.cuda.synchronize()

    loop(WARM_FRAMES)
    pipe.start_trace(ring_frames=SPAN_FRAMES + 8)
    pipe.render(cams[state["k"] % period], dt, collect_stats=True)   # the capture with the marks
    counters = {k: getattr(pipe.last_stats, k) for k in COUNTERS}
    loop(SPAN_FRAMES)
    trace = pipe.stop_trace()
    summary = trace.summary()
    frames = {f.seq for f in trace.steady()[-SPAN_FRAMES:]}
    seams = [[name, ms] for seq, ms, name in trace.seams if seq in frames and seq + 1 in frames]
    seam_ms = sum(ms for _, ms in seams) / len(seams) if seams else None
    names = {n: sum(name == n for name, _ in seams) for n in sorted({n for n, _ in seams})}
    dev = summary["device"]
    stages = sum(dev.get(s, 0.0) for s in GBUFFER_STAGES)
    print(f"[spans] {summary['frames']} traced frames; {len(seams)} seams between the loop's "
          f"frames, named {names}, mean {seam_ms} ms; calibration error "
          f"{trace.calibration_error_ns} ns; the "
          f"five GBuffer stages {stages:.4f} ms vs the GBuffer pass {dev.get('GBuffer')} ms; "
          f"Cull + GBuffer {dev.get('Cull', 0.0) + dev.get('GBuffer', 0.0):.4f} ms; frame "
          f"{dev.get('frame')} ms; counters of one frame {counters}; spans "
          + ", ".join(f"{k} {v:.4f}" for k, v in dev.items()), file=sys.stderr)
    del pipe, cams
    gc.collect()
    torch.cuda.empty_cache()
    return {"summary": summary, "seams": seams, "seam_ms": seam_ms, "counters": counters,
            "calibration_error_ns": trace.calibration_error_ns}
