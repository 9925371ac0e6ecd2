"""torch.profiler over the cell's own loop, and the attribution of each
captured replay's device activities to the frame graph's passes.

A replay launches the device work of the eager frame it was captured from,
in the same order. So one eager frame is rendered with a marker kernel
(`torch.cuda._sleep`, named `spin_kernel` on the device) launched between
its passes; its activities between the markers are each pass's, and every
replay in a trace is matched against that sequence name by name. A trace
whose replays do not match it is refused, never guessed at.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

TRACE_PAD_S = 0.2      # idle time around the traced run: launches near the
                       # edges of a trace have gone missing on an H100
TRACE_TRIES = 3        # traces taken before a partial one fails the run
MARKER = "spin_kernel"
HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")
NAME_CHARS = 160       # a kernel's name in the breakdown, cut (templates run long)


def kind(name: str) -> str:
    """The name an activity is matched by: a copy or a fill is named one way
    when a stream runs it and another when a graph does (`Memcpy DtoD
    (Device -> Device)` against `memcpy_post`), so copies and fills match
    by kind; kernels match by name."""
    low = name.lower()
    for k in ("memcpy", "memset"):
        if low.startswith(k):
            return k
    return name


@dataclass
class Activity:
    name: str
    start: float    # us, on the profiler's clock
    end: float


class AttributionError(RuntimeError):
    """The replays in a trace are not the eager frame's sequence."""


def profiled(run, ranges=()):
    """torch.profiler over `run()`, after a warm-up cycle of the same work
    (traced and dropped): (device activities sorted by start, host ranges
    named in `ranges` as Activities, wall seconds of the traced run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_PAD_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(TRACE_PAD_S)
        prof.step()
    dev, host = [], []
    for e in prof.events():
        a = Activity(e.name, e.time_range.start, e.time_range.end)
        if e.name in ranges:   # a user range is mirrored on the device timeline too
            if e.device_type != DeviceType.CUDA:
                host.append(a)
        elif e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
            dev.append(a)
    dev.sort(key=lambda a: a.start)
    return dev, host, wall


def split_passes(acts: list[Activity], names: list[str]) -> dict[str, list[Activity]]:
    """The eager frame's activities by pass: `names` are the passes in order,
    a marker follows each, the activities before the first pass's (the
    packs' upload) and the device-to-host copy of the counters at the end
    are dropped; what follows the last marker is the counters' gathering,
    returned under "stats"."""
    cut = [i for i, a in enumerate(acts) if MARKER in a.name]
    if len(cut) != len(names) + 1:
        raise AttributionError(f"{len(cut)} markers in the eager frame, want {len(names) + 1}")
    out = {}
    for name, lo, hi in zip(names, cut, cut[1:]):
        out[name] = acts[lo + 1:hi]
    tail = acts[cut[-1] + 1:]
    while tail and tail[-1].name.startswith(HOST_COPIES):
        tail = tail[:-1]
    out["stats"] = tail
    return out


def match_replays(acts: list[Activity], passes: dict[str, list[Activity]], frames: int):
    """[{pass: [activities]}] of each of the `frames` replays in `acts`: each
    replay is a run of activities whose names are the eager frame's, in its
    order. Activities between replays (the camera upload, the carry copy,
    the output clones) belong to no pass. Raises AttributionError unless
    exactly `frames` replays are found."""
    seq = [(p, kind(a.name)) for p, lst in passes.items() for a in lst]
    names = [n for _, n in seq]
    n = len(names)
    got, i = [], 0
    while i + n <= len(acts) and len(got) < frames:
        if [kind(a.name) for a in acts[i:i + n]] == names:
            frame: dict[str, list[Activity]] = {p: [] for p in passes}
            for (p, _), a in zip(seq, acts[i:i + n]):
                frame[p].append(a)
            got.append(frame)
            i += n
        else:
            i += 1
    if len(got) != frames:
        raise AttributionError(
            f"{len(got)} of {frames} replays match the eager frame's {n} activities "
            f"({len(acts)} in the trace); {closest(acts, names)}")
    return got


def closest(acts: list[Activity], names: list[str]) -> str:
    """Where the replay that agrees longest with the eager frame departs."""
    best, at = -1, 0
    for i, a in enumerate(acts):
        if kind(a.name) == names[0]:
            k = next((j for j, (x, y) in enumerate(zip(acts[i:], names)) if kind(x.name) != y),
                     min(len(names), len(acts) - i))
            if k > best:
                best, at = k, i
    if best < 0:
        return "no activity starts like the eager frame"
    got = [a.name[:90] for a in acts[at + best:at + best + 3]]
    return (f"the longest agreement is {best} activities from {at}; then the trace has "
            f"{got}, the eager frame {[x[:90] for x in names[best:best + 3]]}")


def busy_us(acts: list[Activity]) -> float:
    """Microseconds in which some activity ran (the union of intervals)."""
    total, end = 0.0, float("-inf")
    for a in sorted(acts, key=lambda a: a.start):
        if a.end > end:
            total += a.end - max(a.start, end)
            end = a.end
    return total


def top_ops(acts: list[Activity], k: int = 10):
    by: dict[str, float] = {}
    for a in acts:
        by[a.name] = by.get(a.name, 0.0) + (a.end - a.start) / 1e6
    return [[n[:NAME_CHARS], s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(acts: list[Activity], host: list[Activity], k: int = 10):
    """The `k` longest gaps between device activities, each named by the
    innermost host range open at its start ("no range" if none)."""
    gaps, end = [], None
    for a in sorted(acts, key=lambda a: a.start):
        if end is not None and a.start > end:
            gaps.append((end, a.start))
        end = a.end if end is None else max(end, a.end)
    out = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        open_ = [h for h in host if h.start <= lo < h.end]
        name = min(open_, key=lambda h: h.end - h.start).name if open_ else "no range"
        out.append([name, (hi - lo) / 1e6])
    return out
