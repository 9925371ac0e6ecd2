"""The port's frame tracer: device marks inside the frame, host spans at
`render`'s seams, both on one clock. Off by default.

A pipeline holds it in `pipe.tracer` (None unless `pipe.start_trace()` set
it; `pipe.stop_trace()` reads it out into a `Trace` and clears it). Tracing
joins the captured frame's key, so turning it on or off captures the frame
anew; with it off the frame has no mark and `render` tests `tracer is None`
once a seam.

* Device spans (marks). A mark is a one-thread kernel (`csrc/trace_mark.cu`)
  that stores `%globaltimer` (ns) in a device ring of shape int64
  [ring_frames, 2 + MAX_MARKS]. A frame's first mark advances a frame
  counter on the device, clears the row (counter % ring_frames) and stamps
  it with the sequence number and the layout's id; every other mark writes
  its column of that row. A captured frame's marks are nodes of its graph,
  so each replay fills a row with no host involvement, with any number of
  frames in flight; marks launched after a replay, eagerly on the same
  stream (a gloo band frame's post chain, `gather_rows`), land in the row of
  the frame they follow. The host keeps each row's layout: the mark names
  in column order and the span tree, fixed when the frame's code runs (at
  capture for a replayed frame). On the CPU, which runs a frame
  synchronously, a mark stores `time.perf_counter_ns()` in the same ring.
* Spans are recorded by the code that runs the frame: `stage(name, depth)`
  ends the open spans at `depth` and deeper and opens `name` there, at one
  shared mark (the frame graph's passes are stages at depth 1, the GBuffer
  stages at depth 2); `begin(name)` / `end(name)` bracket a span inside the
  innermost open one (`span(name)` is both as a context). The frame itself
  is the root span "frame", from its first mark (`begin_frame`) to its last
  (`finish_frame`).
* Host spans (`Tracer.host(name)`): (name, t0_ns, t1_ns, parent, frame id)
  in memory, each also a `torch.profiler.record_function` of its name, so
  under a profiler the program's ranges and its mark kernels share one
  trace on the profiler's clock.
* One clock without a profiler: `Tracer.calibrate()` reads the device timer
  between two synchronised host reads, several times, keeping the tightest
  pair; device times then convert to `perf_counter_ns`, to within the
  error it states.

`count(name, x)` sets a device counter of the frame to the sum of `x`,
where the pipeline's `_frame` counts (`counting`, on a traced frame, into
the tracer's `counts`): the texture and env plans' taps and staged pages
(`PLAN_COUNTERS`; the anisotropic sampler counts its trilinear taps as
`tex_taps`), which ride the frame's counter vector into `FrameStats`.
An untraced frame sums nothing, so its graph is the untraced one; a traced
one sums straight into `counts` and keeps no tensor of its own alive
through the frame, so the rest of its memory lies where it lies untraced.

A recorder is per thread: trace one pipeline's frames from one thread at a
time.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

MAX_MARKS = 96          # marks a frame's row holds
CALIBRATION_TRIES = 16  # timer readings of a calibration; the tightest is kept
PLAN_COUNTERS = ("tex_taps", "tex_pages_staged", "env_taps", "env_pages_staged")
CALLER = "caller"       # a seam's name where no span of the program was open
_KERNEL = "trace_mark"
_SERIAL = itertools.count(1)
_LOCAL = threading.local()   # .rec: this thread's recorder; .counts: its frame's counters
NO_SPAN = contextlib.nullcontext()


class Layout:
    """A frame's marks in column order and its spans, each [name, begin
    column, end column (None while open), parent span index, depth], as the
    frame's code recorded them; `captured` if recorded into a CUDA graph."""

    def __init__(self, captured: bool):
        self.marks: list[str] = []
        self.spans: list[list] = []
        self.captured = captured
        self._index: dict[tuple, int] = {}

    def signature(self) -> tuple:
        """What frames of one kind share: the marks, the spans, and whether
        they replayed a capture (a capture's eager warm-up frames record
        the same marks)."""
        return self.captured, tuple(self.marks), tuple(tuple(s) for s in self.spans)


class _Recorder:
    """The marks and spans of the frame this thread is running: a new
    layout for a frame that begins here, or, after a replay, the captured
    layout continued where its capture left it."""

    def __init__(self, tracer: "Tracer", layout: Layout, layout_id: int, stack=(), col=0):
        self.tracer, self.layout, self.layout_id = tracer, layout, layout_id
        self.stack = list(stack)   # open spans: (span index, depth)
        self.col = col

    def mark(self, name: str, begin: bool = False) -> int:
        c, lay = self.col, self.layout
        if c >= MAX_MARKS:
            raise RuntimeError(f"trace: a frame of more than {MAX_MARKS} marks")
        if c < len(lay.marks):
            if lay.marks[c] != name:
                raise RuntimeError(f"trace: mark {c} is {name!r} in this frame and "
                                   f"{lay.marks[c]!r} in an earlier one of its layout")
        else:
            lay.marks.append(name)
        self.tracer.write(c, begin, self.layout_id)
        self.col = c + 1
        return c

    def open(self, name: str, col: int, depth: int) -> None:
        lay = self.layout
        i = lay._index.get((name, col))
        if i is None:
            parent = self.stack[-1][0] if self.stack else None
            i = lay._index[(name, col)] = len(lay.spans)
            lay.spans.append([name, col, None, parent, depth])
        self.stack.append((i, depth))

    def close(self, depth: int, col: int) -> None:
        """End the open spans at `depth` and deeper at mark `col`."""
        while self.stack and self.stack[-1][1] >= depth:
            self.layout.spans[self.stack.pop()[0]][2] = col

    def snapshot(self) -> tuple:
        return self.tracer, self.layout, self.layout_id, tuple(self.stack), self.col


def _rec() -> _Recorder | None:
    rec = getattr(_LOCAL, "rec", None)
    return rec if rec is not None and rec.tracer.active else None


def begin_frame(tracer: "Tracer | None") -> None:
    """The frame's first mark (it advances the ring's row) and its root span;
    with no tracer, only forget this thread's last recorder."""
    if tracer is None:
        _LOCAL.rec = None
        return
    capturing = tracer.cuda and torch.cuda.is_current_stream_capturing()
    layout = Layout(captured=capturing)
    tracer.layouts.append(layout)
    rec = _LOCAL.rec = _Recorder(tracer, layout, len(tracer.layouts) - 1)
    if not capturing:
        tracer.frames_begun += 1
    rec.open("frame", rec.mark("frame", begin=True), 0)


def finish_frame() -> None:
    """The frame's last mark: every open span ends there. The recorder stays,
    so later marks on this thread extend the frame's row."""
    rec = _rec()
    if rec is not None and rec.stack:
        rec.close(0, rec.mark("end"))


def stage(name: str, depth: int) -> None:
    """End the open spans at `depth` and deeper and open `name` there, at one
    mark."""
    rec = _rec()
    if rec is not None:
        col = rec.mark(name)
        rec.close(depth, col)
        rec.open(name, col, depth)


def begin(name: str) -> None:
    """Open `name` inside the innermost open span."""
    rec = _rec()
    if rec is not None:
        rec.open(name, rec.mark(name), rec.stack[-1][1] + 1 if rec.stack else 1)


def end(name: str) -> None:
    """End `name` if it is the innermost open span (else nothing)."""
    rec = _rec()
    if rec is not None and rec.stack and rec.layout.spans[rec.stack[-1][0]][0] == name:
        col = rec.mark("/" + name)
        rec.layout.spans[rec.stack.pop()[0]][2] = col


@contextlib.contextmanager
def span(name: str):
    begin(name)
    try:
        yield
    finally:
        end(name)


def clear() -> None:
    _LOCAL.rec = None


def snapshot() -> tuple | None:
    """This thread's recorder as a capture left it (None without one)."""
    rec = _rec()
    return None if rec is None else rec.snapshot()


def resume(state: tuple | None) -> None:
    """After a replay of a graph captured with `state`: the frame it ran has
    begun on the device, and marks on this thread continue its row."""
    if state is None:
        _LOCAL.rec = None
        return
    tracer, layout, layout_id, stack, col = state
    if tracer.active:
        tracer.frames_begun += 1
        _LOCAL.rec = _Recorder(tracer, layout, layout_id, stack, col)


@contextlib.contextmanager
def counting(counts: torch.Tensor):
    """While the block runs on this thread, `count` sets the counters of
    `counts` (int64 [len(PLAN_COUNTERS)] on the frame's device), zeroed
    first: a counter the frame does not count reads 0."""
    prev = getattr(_LOCAL, "counts", None)
    counts.zero_()
    _LOCAL.counts = counts
    try:
        yield counts
    finally:
        _LOCAL.counts = prev


def counted() -> bool:
    """Whether this thread's frame counts: a counter whose input costs work
    of its own builds it only then, so an untraced frame does none."""
    return getattr(_LOCAL, "counts", None) is not None


def count(name: str, x: torch.Tensor) -> None:
    """Set counter `name` of PLAN_COUNTERS to the sum of `x`'s elements where
    the frame counts (one reduction into the counter); elsewhere nothing."""
    counts = getattr(_LOCAL, "counts", None)
    if counts is not None:
        torch.sum(x, dim=tuple(range(x.dim())), out=counts[PLAN_COUNTERS.index(name)])


def _library() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_KERNEL)
    if lib.trace_mark_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trace_mark_launch.argtypes = [p, p, i, i, i, i, i, p]
        lib.trace_now_launch.argtypes = [p, p]
        lib.trace_step_launch.argtypes = [p, i, p]
        for fn in (lib.trace_mark_launch, lib.trace_now_launch, lib.trace_step_launch):
            fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def timer_step_ns(device, iters: int = 200_000) -> int:
    """The smallest nonzero step of the card's `%globaltimer` (its
    resolution) over `iters` reads by one thread."""
    device = torch.device(device)
    out = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        _check(_library().trace_step_launch(out.data_ptr(), iters,
                                            torch.cuda.current_stream(device).cuda_stream),
               "trace_step")
    return int(out.item())


class Tracer:
    """The ring of device marks, the layouts of its rows and the host spans
    of one pipeline's traced frames (`pipe.start_trace`)."""

    def __init__(self, device, ring_frames: int = 64):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.serial = next(_SERIAL)   # a captured frame is keyed on it
        self.ring_frames = ring_frames
        self.width = 2 + MAX_MARKS
        self.ring = torch.full((ring_frames, self.width), -1, dtype=torch.int64,
                               device=self.device)
        self.counts = torch.zeros(len(PLAN_COUNTERS), dtype=torch.int64, device=self.device)
        if self.cuda:
            self.counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        else:
            self._ring_np, self._count = self.ring.numpy(), 0
        self.layouts: list[Layout] = []
        self.host_spans: list[list] = []   # [name, t0_ns, t1_ns, parent index, frame id]
        self.frames_begun = 0
        self.active = True
        self._host = threading.local()

    def write(self, col: int, begin: bool, layout_id: int) -> None:
        """One mark: on a card a kernel on the current stream, on the CPU the
        host clock now."""
        if self.cuda:
            with torch.cuda.device(self.device):
                _check(_library().trace_mark_launch(
                    self.ring.data_ptr(), self.counter.data_ptr(), self.ring_frames, self.width,
                    col, int(begin), layout_id, torch.cuda.current_stream(self.device).cuda_stream),
                    "trace_mark")
            return
        t = time.perf_counter_ns()
        if begin:
            self._count += 1
            row = self._ring_np[self._count % self.ring_frames]
            row[:] = -1
            row[0], row[1] = self._count, layout_id
        self._ring_np[self._count % self.ring_frames, 2 + col] = t

    @contextlib.contextmanager
    def host(self, name: str):
        """A host span: recorded in memory and opened as a
        `torch.profiler.record_function` of the same name."""
        stack = self._host.__dict__.setdefault("stack", [])
        i = len(self.host_spans)
        self.host_spans.append([name, time.perf_counter_ns(), None, stack[-1] if stack else None,
                                self.frames_begun])
        stack.append(i)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.host_spans[i][2] = time.perf_counter_ns()
            stack.pop()

    def calibrate(self) -> tuple[int, int]:
        """(offset, error) in ns: a device time t is the host's
        `perf_counter_ns` t - offset, to within error. Each try reads the
        timer in a kernel launched between two synchronised host reads; the
        tightest pair is kept. (0, 0) on the CPU, whose marks are on the
        host clock."""
        if not self.cuda:
            return 0, 0
        out = torch.zeros(1, dtype=torch.int64, device=self.device)
        lib, best = _library(), None
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            for _ in range(CALIBRATION_TRIES):
                stream.synchronize()
                t0 = time.perf_counter_ns()
                _check(lib.trace_now_launch(out.data_ptr(), stream.cuda_stream), "trace_now")
                stream.synchronize()
                t1 = time.perf_counter_ns()
                g = int(out.item())
                if best is None or t1 - t0 < best[0]:
                    best = (t1 - t0, g - (t0 + t1) // 2)
        return best[1], (best[0] + 1) // 2

    def read(self) -> "Trace":
        """Stop recording and read the ring, the layouts and the host spans
        out into a `Trace` on the host clock."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        offset, err = self.calibrate()
        self.active = False
        clear()
        rows = self.ring.cpu().numpy()
        rows = rows[rows[:, 0] > 0]
        frames = []
        for row in rows[np.argsort(rows[:, 0])]:
            layout = self.layouts[int(row[1])]
            t = row[2:2 + len(layout.marks)]
            ok = t >= 0
            if not ok.any():
                continue
            spans = [(name, int(t[b]) - offset, int(t[e]) - offset, parent, depth)
                     for name, b, e, parent, depth in layout.spans
                     if e is not None and ok[b] and ok[e]]
            frames.append(TraceFrame(int(row[0]), layout.signature(), layout.captured, spans,
                                     int(t[ok].min()) - offset, int(t[ok].max()) - offset))
        host = [tuple(s) for s in self.host_spans if s[2] is not None]
        return Trace(frames, host, _seams(frames, host), err)


@dataclass
class TraceFrame:
    """One frame's row: its spans as (name, t0_ns, t1_ns, parent's index in
    its layout, depth) on the host clock, its first and last marks."""
    seq: int
    signature: tuple
    captured: bool
    spans: list
    first_ns: int
    last_ns: int

    def ms(self) -> dict[str, float]:
        """{span: ms}, spans of one name summed."""
        out: dict[str, float] = {}
        for name, t0, t1, _, _ in self.spans:
            out[name] = out.get(name, 0.0) + (t1 - t0) / 1e6
        return out


def _seams(frames: list[TraceFrame], host: list[tuple]) -> list[tuple]:
    """(seq of the frame before, ms, name) for each pair of consecutive
    frames: the device interval from a frame's last mark to the next one's
    first, named by the innermost host span open at its start (CALLER when
    none of the program's was)."""
    out = []
    for a, b in zip(frames, frames[1:]):
        if b.seq != a.seq + 1:
            continue
        open_ = [h for h in host if h[1] <= a.last_ns < h[2]]
        name = max(open_, key=lambda h: h[1])[0] if open_ else CALLER
        out.append((a.seq, (b.first_ns - a.last_ns) / 1e6, name))
    return out


@dataclass
class Trace:
    """A traced run read out (`Tracer.read`), every time on the host's
    `perf_counter_ns` clock: `frames` (the ring's rows, oldest first),
    `host` spans (name, t0_ns, t1_ns, parent index, frame id), `seams`
    (seq, ms, name) and the calibration's error in ns."""
    frames: list
    host: list
    seams: list
    calibration_error_ns: int

    def steady(self) -> list[TraceFrame]:
        """The frames that ran the last frame's layout: the steady state, not
        a capture's eager warm-up frames."""
        if not self.frames:
            return []
        sig = self.frames[-1].signature
        return [f for f in self.frames if f.signature == sig]

    def summary(self) -> dict:
        """{"frames": steady frames, "device": {span: mean ms a frame},
        "host": {span: mean ms a call}, "seam_ms": mean seam between steady
        frames (None without one), "seams": {name: count}}."""
        steady = self.steady()
        dev: dict[str, float] = {}
        for f in steady:
            for k, v in f.ms().items():
                dev[k] = dev.get(k, 0.0) + v / len(steady)
        host: dict[str, list] = {}
        for name, t0, t1, _, _ in self.host:
            host.setdefault(name, []).append((t1 - t0) / 1e6)
        seqs = {f.seq for f in steady}
        seams = [s for s in self.seams if s[0] in seqs and s[0] + 1 in seqs]
        names: dict[str, int] = {}
        for s in seams:
            names[s[2]] = names.get(s[2], 0) + 1
        return {"frames": len(steady), "device": dev,
                "host": {k: float(np.mean(v)) for k, v in host.items()},
                "seam_ms": float(np.mean([s[1] for s in seams])) if seams else None,
                "seams": names}

    def export_chrome(self, path) -> None:
        """The host spans and the device spans on one clock as a Chrome trace
        (open in Perfetto): process "host" (a track a nesting level) and
        process "device" (a track a depth of the span tree)."""
        times = [h[1] for h in self.host] + [f.first_ns for f in self.frames]
        base = min(times) if times else 0
        events = [{"name": "process_name", "ph": "M", "pid": pid, "args": {"name": name}}
                  for pid, name in ((0, "host"), (1, "device"))]
        for i, (name, t0, t1, parent, frame) in enumerate(self.host):
            depth, p = 0, parent
            while p is not None:
                depth, p = depth + 1, self.host[p][3]
            events.append({"name": name, "ph": "X", "pid": 0, "tid": depth,
                           "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
                           "args": {"frame": frame}})
        for f in self.frames:
            for name, t0, t1, _, depth in f.spans:
                events.append({"name": name, "ph": "X", "pid": 1, "tid": depth,
                               "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
                               "args": {"seq": f.seq}})
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"calibration_error_ns": self.calibration_error_ns}}, fh)
