"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `direct12pbrrenderer_tpu_torch/csrc` (one
nvcc per source, all at once), checks each against its plain PyTorch version
on the card, then renders at 1920x1080 with a procedural sky:

* the 262,144-triangle stress scene through the default path (`use_pallas`
  and `use_tex_kernel` resolve to True on the card): kernel A (raster +
  interpolation), kernel B (page covers of the texture and env caches),
  kernel C (texture resolve + pixel shade), kernel D (fused deferred
  shading) — the main path;
* the same scene through the `use_tex_kernel=False` path: kernel A, the
  direct-atlas sampler and the dense deferred shading;
* the same scene through the planar texture-cache path at a 24x160 raster
  tile (not 128 wide, so the fused G-buffer is off): kernel A's planes, the
  texture cache on its own 24x128 tiling (plan with kernel B, resolve with
  kernel E), the unfused deferred pass with the env cache (kernels B, F);
* the default path with a lo-half texture cap of 156 pages: that cover is
  kernel B's launch at a cap above 128, which stands for the TPU's
  two-kernel cover (kernel I);
* the anisotropic filter (the planar path without kernel E);
* the depth-only raster stage, `stages.rasterize(use_pallas=True)`, on the
  default frame's geometry (kernel H);
* the 1024-light stress scene (the JAX bench's third scene) through the
  1024-light path: kernels A, B, C for the G-buffer, then the unfused
  deferred pass with the env cache (plan with kernel B, resolve with kernel
  F) and the tile-clustered point lights (kernel G);
* the textured cell's content as an asset tree ([asset-auto]): written as
  OBJ/MTL/PNG and HDR faces, imported by the port's importers (BC1, BC6H),
  reloaded through a fresh ResourceLoader and rendered with
  `tex_caps="auto"`: the first frame's tap census runs the depth-only
  kernel H (held to the census with the plain fold), then the sized frames
  run kernels A-D at the census-sized caps, the cascade and the compact
  staging budgets;
* last, the port's bench (`direct12pbrrenderer_tpu_torch.bench`) as a user
  runs it, `--smoke` and then the full run at its default 32 frames: the
  smoke sphere (kernels A, B, E, F), the Sponza-class headline (A-D) and
  the 1024-light cell (A, B, C, F, G) at the JAX bench's knobs, each gate
  binding ([bench] lines).

Each path is driven with the kernels' launch counts set to 0 just before it
and read just after; each frame is checked against the all-plain pipeline
(`use_pallas=False, use_tex_kernel=False`) on the card. Each phase prints
one line; any failure exits non-zero. The line before the last holds every
kernel's numbers with its bound (the least time the card could take for the
bytes and the operations of the call, from NVIDIA's H100 SXM data sheet),
then comes the card's nvidia-smi name and power limit, and the last line is
`{"ok": true, "device": {...}}`. There is no CPU path: without a CUDA device
the script fails. It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

W, H = 1920, 1080
TILE_H, TILE_W, BIN_CAP = 24, 128, 8192
# The cell's cache knobs. With the JAX package's defaults the default frame
# misses the fidelity bar on this cell (PERF.md): rows of the texture planes
# hold more distinct pages than the default row budget of 16, and the BRDF
# LUT's tap group, whose page cap is fixed at 32, overflows at the default
# 512^2 LUT (env_budget cannot help: it only cuts). A 64^2 LUT and row
# budgets of 32/16 bring both fallback counters to 0. [fidelity] also
# records the default knobs' frame, without gating it.
TEX_CAPS = (92, 44, None, (32, 16))
BRDF_LUT = 64
FRAMES, WARMUP = 16, 2    # the default path and the 1024-light path
PLANAR_FRAMES = 4         # the use_tex_kernel=False path
PTEX_FRAMES, ANISO_FRAMES = 8, 2   # the planar texture-cache and anisotropic paths
PTEX_TILE = (24, 160)     # the planar-tex cell's raster tile: not 128 wide
CAP156 = (156, 44, None, (32, 16))  # a lo-half cap above 128: kernel I
RMSE_BAR = 1e-3          # uint8/255 frame rmse, the JAX package's fidelity bar
SHADE_MAX, SHADE_FRAC = 1.01 / 255.0, 2e-3   # kernel C: 1 LSB, on < 0.2% of values
D_RTOL, D_ATOL, D_FRAC = 1e-4, 1e-5, 1e-3    # kernel D: the CPU tests' bar
G_RTOL, G_ATOL, G_COUNTER_FRAC = 1e-4, 1e-5, 1e-4  # kernel G: a log/pow ulp at a
                                                   # cluster edge flips a membership
F_RTOL, F_ATOL = 1e-6, 1e-7   # kernels F and E: the same staged words and weights
# the asset-auto cell: the textured stress cell's terrain (512x256 cells,
# 262,144 triangles) imported from source files, with tex_caps="auto"
ASSET_CELLS = (512, 256)
# the 1024-light cell: the JAX bench's third scene (bench.py _lights1k_bench)
L1K_CELLS, L1K_LIGHTS, L1K_BIN_CAP = (128, 64), 1024, 2048
# NVIDIA H100 SXM data sheet: HBM3 bytes/s and float32 (non-tensor) FLOP/s
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
KERNELS = {  # name -> (TPU kernel it replaces, wrapper module, wrapper, launch counter)
    "raster_interp": ("direct12pbrrenderer_tpu/ops/raster_pallas.py:157", "raster_cuda",
                      "rasterize_interp", "launches"),
    "fused_cover": ("direct12pbrrenderer_tpu/ops/texcache.py:486", "cover_cuda",
                    "fused_cover", "launches"),
    "resolve_shade": ("direct12pbrrenderer_tpu/ops/texcache.py:1024", "resolve_shade_cuda",
                      "resolve_shade", "launches"),
    "deferred_shade": ("direct12pbrrenderer_tpu/ops/shade_pallas.py:61", "shade_fused",
                       "deferred_kernel", "launches"),
    "atlas_resolve": ("direct12pbrrenderer_tpu/ops/texcache.py:992", "atlas_resolve_cuda",
                      "atlas_resolve", "launches"),
    "env_resolve": ("direct12pbrrenderer_tpu/ops/envcache.py:291", "env_resolve_cuda",
                    "env_resolve", "launches"),
    "point_lights": ("direct12pbrrenderer_tpu/ops/lights_pallas.py:138", "lights_cuda",
                     "point_lights_kernel", "launches"),
    "raster_depth": ("direct12pbrrenderer_tpu/ops/raster_pallas.py:88", "raster_cuda",
                     "rasterize_depth", "launches"),
    # kernel I, the TPU's two-kernel cover for caps above 128: on the card
    # kernel B's launch at such a cap, counted apart (and in B's count too)
    "cover_wide": ("direct12pbrrenderer_tpu/ops/texcache.py:278 (_block_cover_kernel) and "
                   "direct12pbrrenderer_tpu/ops/texcache.py:331 (_pix_match_kernel)",
                   "cover_cuda", "fused_cover", "wide_launches"),
}
WIDE = "cover_wide"
# the port's bench (`python -m direct12pbrrenderer_tpu_torch.bench`): each
# cell and the kernels its path launches on the card. The smoke scene's
# tile is 64 wide, so its frame takes the planar texture cache (B, E) and
# the unfused deferred pass with the env cache (B, F).
BENCH_CELLS = {
    "smoke": ("raster_interp", "fused_cover", "atlas_resolve", "env_resolve"),
    "sponza_class": ("raster_interp", "fused_cover", "resolve_shade", "deferred_shade"),
    "lights1k": ("raster_interp", "fused_cover", "resolve_shade", "env_resolve",
                 "point_lights"),
}
BENCH_TRACE = 8   # frames of each bench cell traced by torch.profiler
SOURCES = {WIDE: "fused_cover"}   # kernel I runs kernel B's source and device kernel


def source_of(name: str) -> str:
    """The csrc/ source (without .cu) that builds kernel `name`; its device
    kernel is `<source>_kernel`."""
    return SOURCES.get(name, name)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    say(phase, "FAIL " + msg)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs (CUDA events, after one
    warm-up). The runs repeat on the same inputs, so what fits in the 50 MB
    L2 stays there: a warm-L2 time (`cold_ms` evicts it)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call of `fn` without the host between its
    launches: CUDA events around replays of a CUDA graph that captured one
    call (after a warm-up call, which fills the kernels' grid caches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms


def host_ms(fn, reps: int) -> float:
    """Mean host time of one run of `fn` (perf_counter over `reps` runs
    without synchronizing, after one warm-up): a wrapper's checks and launch.
    Where it exceeds the device time, `cuda_ms` times the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


TRACE_TRIES = 5
L2_EVICT_BYTES = 512 << 20    # ten times the H100's 50 MB L2
TRACES = {"complete": 0, "partial": []}   # every kernel trace of this run
EARLIER_BOUNDS: dict[str, float] = {}      # name -> ms of a kernel's earlier, looser bound


def cold_ms(fn, reps: int) -> float:
    """Mean device time of one run of `fn` with its inputs out of the L2:
    CUDA events around each run, after a write of L2_EVICT_BYTES outside
    them, which evicts the 50 MB L2 and keeps the card busy while the host
    launches the run (so the events time the device work alone)."""
    evict = torch.empty(L2_EVICT_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        evict.fill_(0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def traced(run):
    """torch.profiler over `run()`: ([(name, us)] of its device activities,
    {kernel: launches it made}, its wall ms). A warm-up cycle of the same
    work, traced and dropped, comes first (the profiler's own schedule): on
    an H100 the first launches of a trace have gone missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        n0 = read_launches()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    launched = {k: n - n0[k] for k, n in read_launches().items()}
    # the schedule's step annotation spans the device timeline: not an activity
    spans = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep")]
    return spans, launched, wall


def device_spans(fn, reps: int, name: str) -> list[tuple[str, float]]:
    """(name, us) of every device activity (kernels, copies, memsets) of
    `reps` runs of `fn`, a call of kernel `name`'s wrapper (`traced`). Only
    a complete trace counts: one that holds exactly as many activities of
    the kernel (`<name>_kernel`) as the wrapper launched during the traced
    runs. torch.profiler on an H100 has returned traces without some or all
    of them; a partial trace is recorded in TRACES and traced again, up to
    TRACE_TRIES times."""
    kernel = f"{name}_kernel"
    for _ in range(TRACE_TRIES):
        spans, launched, _ = traced(lambda: [fn() for _ in range(reps)])
        got = sum(1 for n, _ in spans if kernel in n)
        if got == launched[name] > 0:
            TRACES["complete"] += 1
            return spans
        TRACES["partial"].append(f"{name} {got}/{launched[name]}")
    fail("profiler", f"no complete trace of {kernel} in {TRACE_TRIES} tries: {TRACES['partial']}")


def device_ms(fn, reps: int, name: str) -> tuple[float, float]:
    """Mean device time per run of `fn`, a call of kernel `name`'s wrapper
    (torch.profiler, `device_spans`; a warm-L2 time, as `cuda_ms`): of the
    kernel alone, without the wrapper's own tensor work, and of all its
    device work. Where the second is well under the run's CUDA-event time,
    the card waits on the host between the run's launches."""
    spans = device_spans(fn, reps, name)
    us = sum(t for n, t in spans if f"{name}_kernel" in n)
    return us / 1e3 / reps, sum(t for _, t in spans) / 1e3 / reps


OUTPUT_OPS = ("aten.empty.memory_format",)   # a wrapper allocating its output


def dispatched_ops(fn) -> list[str]:
    """The aten ops that one run of `fn` dispatches (a TorchDispatchMode):
    every tensor operation, whether or not torch.profiler records its
    device work."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return ops


def only_kernel(phase, fn, name: str) -> list[str]:
    """Fail unless a call of kernel `name`'s wrapper `fn` does no tensor
    work but allocating its output (`dispatched_ops`) and puts nothing on
    the device but its kernel: no layout copy, memcpy or memset (a complete
    torch.profiler trace of 10 calls). Returns the dispatched ops."""
    ops = dispatched_ops(fn)
    if not ops or any(op not in OUTPUT_OPS for op in ops):
        fail(phase, f"one wrapper call dispatched {ops}, want only {OUTPUT_OPS}")
    others = sorted({n for n, _ in device_spans(fn, 10, name) if f"{name}_kernel" not in n})
    if others:
        fail(phase, f"wrapper calls ran device work besides {name}_kernel: {others}")
    return ops


def compare(phase, got, want) -> tuple[float, int]:
    """Hold a raster's outputs (tri_id, z[, planes]) against another's bit for
    bit: kernels A and H and their plain versions evaluate the same float32
    formulas with every product and sum rounded on its own and one tie rule.
    Returns (max abs error of z and planes where the ids agree, id
    mismatches), both 0 when it passes."""
    ids_k, ids_p = got[0], want[0]
    agree = ids_k == ids_p
    if not (agree & (ids_p >= 0)).any():
        fail(phase, "no covered pixels")
    err = max(float((k - p).abs()[..., agree].max()) for k, p in zip(got[1:], want[1:]))
    nmis = int((~agree).sum())
    for name, k, p in zip(("tri_id", "z", "planes"), got, want):
        if not torch.isfinite(k.float()).all():
            fail(phase, f"non-finite {name}")
        if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
            fail(phase, f"{name} not bit-equal: {nmis} id mismatches of {ids_k.numel()}, max "
                 f"abs error {err:.3e} where the ids agree")
    return err, nmis


def nbytes(*xs) -> int:
    """Bytes of the tensors among `xs`."""
    return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))


def staged_read_bytes(off, cnts, staged, rec, rows_per_page: int, reads=None) -> int:
    """Bytes of the staged page words that the taps `rec` (tiles, G, blocks,
    128) address, each counted once: a tap reads `rows_per_page` words of
    lane rec & 127 of page off + (rec >> 7) of its tile, when that page lies
    inside its group's ceil8(cnt) span and the staged budget, and `reads`
    (a bool tensor of rec's shape, if given) says the output reads the tap."""
    tiles, g = rec.shape[:2]
    budget = staged.shape[1] // rows_per_page
    seg = rec >> 7
    page = off[:, :g, None, None] + seg
    ok = ((seg >= 0) & (seg < ((cnts[:, :g] + 7) // 8 * 8)[:, :, None, None])
          & (page < budget))
    if reads is not None:
        ok = ok & reads
    t = torch.arange(tiles, device=rec.device).view(-1, 1, 1, 1)
    key = ((t * budget + page).long() * 128 + (rec & 127))[ok]
    return torch.unique(key).numel() * rows_per_page * 4


def resolve_shade_reads(sargs, skw) -> dict[str, torch.Tensor]:
    """Which words of kernel C's per-pixel planes its output reads, as bool
    tensors of each plane's shape. A background pixel (flags[5] 0) reads
    its coverage flag and writes zeros. A lit one reads attrs 0-2, 9 and
    12-16 (normal, emission, the slots' use flags), the tangent (attrs 3-5)
    only where the normal map is used, the fallbacks (attrs 6-8, 10, 11)
    only where their slot is not; slot s's sRGB flag, its cascade mask and
    its taps only where attrs[12 + s] > 0.5: the cascade re-tap where sel is
    set, else the lo tap and, trilinear, the hi tap and the frac."""
    rec, tl, attrs, flags = sargs[3], sargs[6], sargs[7], sargs[8]
    sel = sargs[9] if len(sargs) > 9 else None
    trilinear = skw.get("trilinear", True)
    lit = (flags[:, 5] != 0)[:, None]                  # (tiles, 1, blocks, 128)
    use = (attrs[:, 12:17] > 0.5) & lit                # slot s read
    casc = use & (sel != 0) if sel is not None else torch.zeros_like(use)
    plain = use & ~casc
    taps = torch.cat([plain] + [plain] * trilinear + [casc] * (sel is not None), 1)
    ch = [lit] * 3 + [lit & use[:, 1:2]] * 3 + [lit & ~use[:, 0:1]] * 3 + [lit] + [
        lit & ~use[:, 3:4], lit & ~use[:, 2:3]] + [lit] * 5
    reads = {"rec": taps, "fx": taps, "fy": taps, "tl": plain & trilinear,
             "attrs": torch.cat(ch, 1).expand(attrs.shape),
             "flags": torch.cat([use, torch.ones_like(lit)], 1)}
    if sel is not None:
        reads["sel"] = use
    assert tuple(taps.shape) == tuple(rec.shape) and tuple(reads["tl"].shape) == tuple(tl.shape)
    return reads


def deferred_reads(dargs, dkw) -> dict[str, torch.Tensor]:
    """Which words of kernel D's per-pixel planes its output reads, as bool
    tensors of each plane's shape. Every pixel reads its mask and view depth
    (gb 10 and 9: the light loop's hit counter is written everywhere). A
    background pixel reads the sky tap (group 3) and nothing else. A lit one
    reads gb 0-8 and 12, the BRDF tap (group 2), and the irradiance by the
    coverage flags: where cov0, the exact taps 0 and 1 and fracm (gb 11);
    else, with env content, cov4 (gb 13) and the cascade tap (group 4) where
    cov4 is set, tap 0 where it is not; without env content, tap 0."""
    gb, rec = dargs[8], dargs[5]
    has_env = dkw["has_env"]
    lit = gb[:, 10] > 0.5
    cov0, cov4 = gb[:, 12] > 0.5, (gb[:, 13] > 0.5) & has_env
    taps = [lit & (cov0 | ~cov4), lit & cov0, lit, ~lit] + [lit & ~cov0 & cov4] * has_env
    every = torch.ones_like(lit)
    ch = [lit] * 9 + [every, every, lit & cov0, lit, lit & ~cov0 & has_env]
    taps = torch.stack(taps, 1)
    assert tuple(taps.shape) == tuple(rec.shape)
    return {"rec": taps, "fx": taps, "fy": taps, "gb": torch.stack(ch, 1)}


def bound(n_bytes: float, flops: float = 0.0) -> tuple[float, str]:
    """(least ms, what bounds it) for a call that must move `n_bytes` (each
    input read once, each output written once) and do `flops` float32
    operations: the larger of the two times at the H100's data-sheet rates."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wrapper(name: str):
    """(wrapper function, the name of its launch counter) of kernel `name`."""
    import importlib

    _, mod, fn, counter = KERNELS[name]
    module = importlib.import_module(f"direct12pbrrenderer_tpu_torch.ops.{mod}")
    return getattr(module, fn), counter


def reset_launches() -> None:
    for name in KERNELS:
        setattr(*wrapper(name), 0)


def set_launches(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        setattr(*wrapper(name), n)


def read_launches() -> dict[str, int]:
    # a counter the wrapper lacks reads 0 (kernel_ab.py runs older trees)
    return {name: getattr(*wrapper(name), 0) for name in KERNELS}


@contextlib.contextmanager
def recording(module, name: str):
    """Record (args, kwargs) of every call of `module.name` while the block
    runs; the calls still go through. Launches made meanwhile are counted on
    the recorder, not on the wrapper."""
    orig = getattr(module, name)
    calls = []

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    rec.launches = rec.wide_launches = 0
    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def counting(module, name: str, launches: dict):
    """While the block runs, each call of `module.name` runs with every launch
    count set to 0 just before it; the counts read just after go to
    `launches[name]`."""
    orig = getattr(module, name)

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        reset_launches()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        launches[name] = read_launches()
        return out

    setattr(module, name, run)
    try:
        yield
    finally:
        setattr(module, name, orig)


def bench_faults(result: dict, launches: dict[str, dict[str, int]]) -> list[str]:
    """What fails the [bench] phase in one of the bench's JSON lines, given
    each cell's kernel launches: a cell that launched none of a kernel its
    path runs, a gate that still fails after its re-measure, and any
    re-measure at all, since a cell that fell back reports the plain
    samplers' fps and rmse, not its kernels'."""
    faults = [f"cell {cell} launched none of kernels {missing}"
              for cell, counts in launches.items()
              if (missing := [k for k in BENCH_CELLS[cell] if not counts[k]])]
    faults += [f"{k} is {v!r}: the cell's numbers are the gate-safe re-measure's, not its "
               f"kernels'" for k, v in result.items() if k.endswith("fidelity_fallback")]
    from direct12pbrrenderer_tpu_torch.bench import failed_gates

    faults += [f"gate {k} fails after the gate-safe re-measure" for k in failed_gates(result)]
    return faults


def hold_bench_cell(cell: str, pipe, cam) -> str:
    """One frame of bench cell `cell` at its pose with the wrappers of its
    path's kernels recorded, each recorded call held to its plain version on
    the same inputs (`hold_call`); then torch.profiler over BENCH_TRACE
    frames of the pose, enqueued back to back as the bench's loop enqueues
    them. The launches made here are taken off the counts again."""
    import importlib

    keep = read_launches()
    names = BENCH_CELLS[cell]
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(recording(importlib.import_module(
            f"direct12pbrrenderer_tpu_torch.ops.{KERNELS[name][1]}"), KERNELS[name][2]))
            for name in names}
        pipe.render(cam, 1.0 / 60.0, collect_stats=False)
        torch.cuda.synchronize()
    parts = []
    for name in names:
        if not calls[name]:
            fail(f"bench-{cell}", f"a frame at the bench pose made no call of {name}")
        errs = [hold_call(f"bench-{cell}", name, args, kw) for args, kw in calls[name]]
        parts.append(f"{name} {len(errs)} calls, max_abs_err {max(errs):.3e}")
    del calls
    wall, busy, n_act, top = profiled_frames(pipe, cam, BENCH_TRACE)
    set_launches(keep)
    return (f"{cell}: one frame's kernel calls held to their plain versions at the kernels "
            f"line's bars: " + "; ".join(parts) + f"; torch.profiler over {BENCH_TRACE} frames: "
            f"wall {wall:.2f} ms/frame, device busy {busy:.2f} ms/frame ({n_act:.0f} device "
            f"activities), idle share {1 - busy / wall:.3f}; top: "
            + "; ".join(f"{ms:.2f} ms {name[:60]}" for ms, name in top))


def hold_call(phase: str, name: str, args, kw) -> float:
    """Hold one recorded call of kernel `name`'s wrapper against its plain
    version on the same inputs, at the bar the kernels line holds it to;
    returns the max abs error."""
    fn, _ = wrapper(name)
    ref = getattr(sys.modules[fn.__module__], f"{KERNELS[name][2]}_reference")
    if name == "raster_interp":   # the plain version gives the untiled outputs
        kw = {k: v for k, v in kw.items() if k != "return_tiled"}
    got, want = fn(*args, **kw), ref(*args, **kw)
    if name == "raster_interp":
        return compare(phase, got, want)[0]
    if name == "fused_cover":
        for g, r, out in zip(got, want, ("list", "count", "slot", "covered")):
            if not torch.equal(g, r):
                fail(phase, f"fused_cover: {out} differs from the plain version")
        return 0.0
    if name == "resolve_shade":
        return check_shade(phase, got, want)
    if name == "deferred_shade":
        return check_deferred(phase, got, want)[0]
    if name == "point_lights":
        return check_lights(phase, args, got, want)[0]
    return check_close(phase, got, want)   # kernels E and F


def bench_phase(runs=(["--smoke"], [])) -> None:
    """The port's bench as a user runs it: `--smoke`, then the full run at
    1920x1080 with its default 32 frames (the sponza_class headline, then
    lights1k). Each JSON line is printed under [bench] with each cell's
    kernel launches, and after each cell's measurement its kernels are held
    to their plain versions and its frames traced (`hold_bench_cell`).
    Fails on any of `bench_faults`."""
    from unittest import mock

    from direct12pbrrenderer_tpu_torch import bench

    for argv in runs:
        cells = ["smoke"] if "--smoke" in argv else ["sponza_class", "lights1k"]
        held, launches, out, real_stdout = [], {}, io.StringIO(), sys.stdout
        measure = bench._measure_cell

        def measure_and_hold(pipe, cam, frames):
            cell = measure(pipe, cam, frames)
            with contextlib.redirect_stdout(real_stdout):   # a failing hold says why
                held.append(hold_bench_cell(cells[len(held)], pipe, cam))
            return cell

        t0 = time.perf_counter()
        with mock.patch.object(bench, "_measure_cell", measure_and_hold), \
                counting(bench, "_stress_bench", launches), \
                counting(bench, "_lights1k_bench", launches), \
                contextlib.redirect_stdout(out):
            torch.cuda.synchronize()
            reset_launches()
            result = bench.main(argv)
            torch.cuda.synchronize()
        if "--smoke" in argv:
            cell_launches = {"smoke": read_launches()}
        else:
            cell_launches = {"sponza_class": launches["_stress_bench"],
                             "lights1k": launches["_lights1k_bench"]}
        say("bench", out.getvalue().strip().splitlines()[-1])
        for line in held:
            say("bench", line)
        for cell, counts in cell_launches.items():
            say("bench", f"{cell}: kernel launches {counts}")
        faults = bench_faults(result, cell_launches)
        if faults:
            fail("bench", "; ".join(faults))
        say("bench", f"{' '.join(argv) or 'full run'}: every gate passes on the kernels' "
            f"path; {time.perf_counter() - t0:.1f} s")


class _RandomTexture:
    """A random RGBA8 texture with a full mip chain (scene_pack's atlas input)."""

    def __init__(self, rng, w, h, srgb):
        from direct12pbrrenderer_tpu_torch.resource.formats import ETextureFormat

        self.format = (ETextureFormat.R8G8B8A8_UNORM_SRGB if srgb
                       else ETextureFormat.R8G8B8A8_UNORM)
        self.mips = []
        while True:
            self.mips.append(rng.integers(0, 256, (h, w, 4), dtype=np.uint8))
            if w == 1 and h == 1:
                break
            w, h = max(w >> 1, 1), max(h >> 1, 1)
        self.mip_levels = len(self.mips)

    def mip_array_rgba(self, mip):
        return self.mips[mip]


def stub_atlas(rng, device, specs=((32, 16, True), (16, 16, False), (8, 8, False))):
    """A texture atlas of random mip chains on `device`."""
    from direct12pbrrenderer_tpu_torch.pipeline import scene_pack
    from direct12pbrrenderer_tpu_torch.ops.gbuffer import AtlasDevice

    builder = scene_pack._AtlasBuilder()
    for w, h, srgb in specs:
        builder.add(_RandomTexture(rng, w, h, srgb))
    a = builder.build()
    return AtlasDevice.from_numpy(a.data, a.page_base, a.base_size, a.n_mips, a.srgb,
                                  device=device)


def random_raster_planes(rng, h, w, th, tw):
    """Kernel A's tile blocks for synthetic content: smooth uv ramps, random
    normals/tangents and material rows (texture ids 0..2), 15% background.
    -> (pl_tiles (tiles, p, 24) f32, id_tiles (tiles, p, 1) int32)."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = np.stack([xx / w * 1.5 - 0.2 + rng.random((h, w)) * 0.01,
                   yy / h * 1.2 + rng.random((h, w)) * 0.01], 0)
    mat = np.zeros((16, h, w))
    mat[0:6] = rng.random((6, h, w))
    mat[6:11] = rng.random((5, h, w)) > 0.4
    mat[11:16] = rng.integers(0, 3, (5, h, w))
    planes = np.concatenate([uv, rng.normal(size=(6, h, w)), mat], 0).astype(np.float32)
    ids = np.where(rng.random((1, h, w)) > 0.15, 1, -1).astype(np.int32)

    def tiles(x):
        c = x.shape[0]
        return np.ascontiguousarray(x.reshape(c, h // th, th, w // tw, tw)
                                    .transpose(1, 3, 2, 4, 0).reshape(-1, th * tw, c))

    return tiles(planes), tiles(ids)


def random_triangles(n: int, seed: int, device):
    """Random small triangles across ndc with w = 1 (the JAX package's raster
    test scene): (clip (3n, 4), tris (n, 3), payload (n, 40)), the payload a
    random material row and vertex-attribute rows (rows64 columns 16:56)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32)
    d = rng.uniform(-0.2, 0.2, (n, 2, 3)).astype(np.float32)
    v = np.concatenate([c, c + d], axis=1)
    v[..., 2] = rng.uniform(0.05, 0.95, (n, 3))
    verts = v.reshape(-1, 3)
    clip = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], axis=1)
    tris = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    rng = np.random.default_rng(seed + 100)
    payload = np.concatenate([rng.uniform(0, 1, (n, 16)), rng.uniform(-1, 1, (n, 24))],
                             1).astype(np.float32)
    t = torch.as_tensor
    return t(clip, device=device), t(tris, device=device), t(payload, device=device)


def procedural_sky(size: int, sun_dir, sun_intensity: float):
    """HDR sky cubemap (horizon gradient + sun disc) with SH baked on the
    host, as the console's CreateProceduralSky builds it."""
    from direct12pbrrenderer_tpu_torch.resource.formats import ETextureFormat
    from direct12pbrrenderer_tpu_torch.resource.resources import CubeMapResource
    from direct12pbrrenderer_tpu_torch.resource.storage import CubeMapTextureData, TextureData
    from direct12pbrrenderer_tpu_torch.ops.common import cubemap_face_dirs

    dirs = cubemap_face_dirs(size)
    y = dirs[..., 1:2]
    horizon = np.array([0.35, 0.45, 0.65], np.float32)
    zenith = np.array([0.08, 0.18, 0.45], np.float32)
    ground = np.array([0.25, 0.22, 0.18], np.float32)
    t = np.clip(y, 0, 1) ** 0.6
    sky = horizon * (1 - t) + zenith * t
    sky = np.where(y < 0, ground * (1 + y), sky).astype(np.float32)
    sun = np.array(sun_dir, np.float32)
    sun /= np.linalg.norm(sun)
    cos = (dirs * sun).sum(-1, keepdims=True)
    sky = (sky + np.exp((cos - 1.0) * 800.0) * sun_intensity).astype(np.float32)
    faces = [
        TextureData.from_array(np.concatenate([sky[i], np.ones_like(sky[i][..., :1])], -1),
                               ETextureFormat.R32G32B32A32_FLOAT)
        for i in range(6)
    ]
    res = CubeMapResource("mem/sky")
    res.cubemap = CubeMapTextureData(faces=faces)
    return res


def stress_scene(cells_x: int, cells_y: int, sky_size: int, sun_intensity: float,
                 n_lights: int = 8):
    """tools/stress_scene's terrain and `n_lights` lights with its albedo map
    switched on (build_stress_scene attaches the 256x256 sRGB checker but not the
    material's UseAlbedoMap flag, which leaves the texture out of the atlas)
    and a procedural HDR sky, so every cache and kernel of the frame does
    work."""
    from direct12pbrrenderer_tpu_torch.tools.stress_scene import build_stress_scene

    scene = build_stress_scene(cells_x, cells_y, n_lights=n_lights)
    for sm in scene.models:
        for mat in sm.model.materials:
            mat.set_parameter("UseAlbedoMap", True)
    scene.set_skybox(procedural_sky(sky_size, (0.4, 0.6, 0.3), sun_intensity))
    return scene


def textured_cell(dev):
    """The textured stress cell on `dev`: (scene, render config, the JAX
    package's cache knobs, the cell's knobs, the default pipeline, the
    default frame's camera)."""
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera

    scene = stress_scene(512, 256, 256, 80.0)
    cfg = RenderConfig(W, H, max_instances=2)
    base_knobs = dict(tile_h=TILE_H, tile_w=TILE_W, bin_cap=BIN_CAP, atlas_max_dim=256)
    knobs = dict(base_knobs, brdf_lut_size=BRDF_LUT)
    pipe = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps=TEX_CAPS, **knobs)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    return scene, cfg, base_knobs, knobs, pipe, cam


def frame_inputs(pipe, cam):
    """The GBuffer pass's geometry/binning/rows64 for one pose, outside the
    graph (for the kernel-vs-plain check at the main path's shapes), and the
    device ms of each of those stages."""
    from direct12pbrrenderer_tpu_torch.ops import common
    from direct12pbrrenderer_tpu_torch.pipeline import stages

    p, dev, cfg = pipe.packed, pipe.device, pipe.config
    mm = torch.as_tensor(p.model_mats, dtype=torch.float32, device=dev)
    nm = torch.as_tensor(np.ascontiguousarray(np.transpose(p.inv_model_mats[:, :3, :3],
                                                           (0, 2, 1))),
                         dtype=torch.float32, device=dev)
    planes = torch.as_tensor(np.asarray(cam.frustum_planes(), np.float32), device=dev)
    bounds = torch.as_tensor(p.instance_bounds, dtype=torch.float32, device=dev)
    vis = torch.zeros(mm.shape[0], dtype=torch.bool, device=dev)
    n = p.instance_count
    vis[:n] = common.frustum_cull_aabbs(planes, bounds[:n, 0], bounds[:n, 1])
    vp = torch.as_tensor(np.asarray(cam.projection_matrix() @ cam.view_matrix(), np.float32),
                         device=dev)

    def geometry():
        return stages.geometry(pipe.buffers, mm, nm, vis, vp, cfg.width, cfg.height)

    setup, vattrs = geometry()

    def binning():
        return stages.binning(setup, pipe.render_w, pipe.render_h, pipe.tile_h, pipe.tile_w,
                              pipe.bin_cap)

    bins = binning()
    rows64 = stages.pack_rows64(setup, pipe.buffers, vattrs)
    ms = {"geometry": cuda_ms(geometry, 3), "binning": cuda_ms(binning, 3),
          "pack_rows64": cuda_ms(lambda: stages.pack_rows64(setup, pipe.buffers, vattrs), 3)}
    return setup, bins, rows64, ms


def timed_passes(pipe, cam, frames: int) -> dict[str, float]:
    """Mean device ms per graph pass (CUDA events around each pass)."""
    from direct12pbrrenderer_tpu_torch.graph import frame_graph as fg

    graph = pipe.graph
    events: dict[str, list] = {}

    def wrap(pass_):
        def fn(env):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = pass_.fn(env)
            e.record()
            events.setdefault(pass_.name, []).append((s, e))
            return out
        return fg.RenderPass(pass_.name, pass_.reads, pass_.writes, fn, pass_.declares)

    pipe.graph = fg.CompiledGraph([wrap(p) for p in graph.order], graph.lifetimes,
                                  graph.donatable, graph.descriptions)
    try:
        for _ in range(frames):
            pipe.render(cam, 1.0 / 60.0, collect_stats=False)
        torch.cuda.synchronize()
    finally:
        pipe.graph = graph
    return {k: sum(s.elapsed_time(e) for s, e in v) / len(v) for k, v in events.items()}


def profiled_frames(pipe, cam, frames: int):
    """torch.profiler over `frames` frames (`traced`): (wall ms per frame,
    device busy ms per frame, device activities per frame, [(ms per frame,
    kernel name)] of the top five). Busy time sums the device activities
    (kernels and copies run one at a time on the frame's single stream). As
    in `device_spans`, only a trace that holds every launch of the port's
    kernels counts; a partial one is recorded in TRACES and traced again."""
    def run():
        for _ in range(frames):
            pipe.render(cam, 1.0 / 60.0, collect_stats=False)

    for _ in range(TRACE_TRIES):
        spans, launched, wall = traced(run)
        held = {name: sum(1 for n, _ in spans if f"{name}_kernel" in n) for name in KERNELS
                if source_of(name) == name}
        if all(launched[k] == v for k, v in held.items()):
            TRACES["complete"] += 1
            break
        TRACES["partial"].append("frame " + ", ".join(
            f"{k} {v}/{launched[k]}" for k, v in held.items() if launched[k] != v))
    else:
        fail("profiler", f"no complete trace of {frames} frames in {TRACE_TRIES} tries: "
             f"{TRACES['partial']}")
    by_name: dict[str, float] = {}
    for n, us in spans:
        by_name[n] = by_name.get(n, 0.0) + us
    top = sorted(((v / 1e3 / frames, k) for k, v in by_name.items()), reverse=True)[:5]
    busy = sum(by_name.values()) / 1e3 / frames
    return wall / frames, busy, len(spans) / frames, top


def build_kernels() -> None:
    """One nvcc per kernel source, all started together; one line each."""
    from direct12pbrrenderer_tpu_torch.kernels import build

    def timed(name):
        t0 = time.perf_counter()
        lib, log = build.build(name)
        return lib, log, time.perf_counter() - t0

    sources = sorted({source_of(name) for name in KERNELS})
    with ThreadPoolExecutor(len(sources)) as ex:
        futures = {name: ex.submit(timed, name) for name in sources}
    for name, fut in futures.items():
        lib, log, secs = fut.result()
        ptxas = " ".join(l.strip() for l in log.splitlines() if "registers" in l or "spill" in l)
        say("build", f"{name}.cu -> {lib.name} in {secs:.2f} s; ptxas: "
            f"{ptxas or 'reused build'}")


def check_shade(phase, got, want) -> float:
    """Kernel C's bar: every value within 1.01/255, < 0.2% of values differ."""
    a, b = got.cpu().numpy(), want.cpu().numpy()
    if not np.isfinite(a).all():
        fail(phase, "non-finite kernel output")
    diff = np.abs(a - b)
    frac = float((diff > 1e-6).mean())
    if diff.max() > SHADE_MAX or frac >= SHADE_FRAC:
        fail(phase, f"max diff {diff.max():.3e} (bar {SHADE_MAX:.3e}), {frac:.2e} of values "
             f"differ (bar {SHADE_FRAC})")
    return float(diff.max())


def check_deferred(phase, got, want) -> tuple[float, float]:
    """Kernel D's bar: rgb within rtol 1e-4 / atol 1e-5 on all but 0.1% of
    the pixels; the hit counter equal on all but 0.1%."""
    a, b = got.cpu().numpy(), want.cpu().numpy()
    if not np.isfinite(a).all():
        fail(phase, "non-finite kernel output")
    bad = ~np.isclose(a[:, :3], b[:, :3], rtol=D_RTOL, atol=D_ATOL).all(1)
    cnt_bad = a[:, 3] != b[:, 3]
    if bad.mean() > D_FRAC or cnt_bad.mean() > D_FRAC:
        fail(phase, f"{bad.mean():.2e} of pixels outside rtol {D_RTOL}/atol {D_ATOL}, "
             f"{cnt_bad.mean():.2e} with another hit count (bar {D_FRAC})")
    return float(np.abs(a - b).max()), float(bad.mean())


def check_close(phase, got, want) -> float:
    """Kernels E and F's bar: rtol 1e-6 / atol 1e-7, every value finite."""
    if not torch.isfinite(got).all() or not torch.allclose(got, want, rtol=F_RTOL, atol=F_ATOL):
        fail(phase, f"outside rtol {F_RTOL}/atol {F_ATOL}: max abs diff "
             f"{float((got - want).abs().max()):.3e}")
    return float((got - want).abs().max())


def check_lights(phase, gargs, got, want) -> tuple[float, np.ndarray]:
    """Kernel G's bar: the hit count equal on all but 1e-4 of the pixels, and
    where it is equal on a pixel with mask 1, rgb within rtol 1e-4 / atol
    1e-5. Returns (max abs rgb error there, where the hit counts agree)."""
    a, b = got.cpu().numpy(), want.cpu().numpy()
    if not np.isfinite(a).all():
        fail(phase, "non-finite kernel output")
    same = a[..., 3] == b[..., 3]
    masked = same & (gargs[3][..., 9].cpu().numpy() > 0.5)
    bad = ~np.isclose(a[..., :3][masked], b[..., :3][masked], rtol=G_RTOL, atol=G_ATOL)
    if (~same).mean() >= G_COUNTER_FRAC or bad.any():
        fail(phase, f"{int((~same).sum())} pixels with another hit count (bar "
             f"{G_COUNTER_FRAC} of {same.size}), {int(bad.sum())} rgb values outside rtol "
             f"{G_RTOL}/atol {G_ATOL}")
    return float(np.abs(a[..., :3][masked] - b[..., :3][masked]).max(initial=0.0)), same


def plane_layouts(xs) -> str:
    """The strides of the per-pixel planes among `xs` ((tiles, G, blocks,
    128) tensors), as the kernels read them."""
    return ", ".join(f"{tuple(x.shape)}: {x.stride()}" for x in xs
                     if isinstance(x, torch.Tensor) and x.dim() == 4)


def deferred_census(dargs, dkw) -> str:
    """Kernel D's light loop on its inputs, from the plain version run over
    the first s active lights for s = 1..n (its hit counter then says which
    pixels light s hit): lit pixels, (pixel, light) hits, and the bodies a
    full loop evaluates (pixels x lights) against those of a loop that skips
    a light for a warp (32 pixels of a row) none of whose lit pixels it hits."""
    from direct12pbrrenderer_tpu_torch.ops import shade_fused

    const, lights, gb = dargs[0], dargs[1], dargs[8]
    n = min(int(const[21]), lights.shape[0])
    mask = gb[:, 10] > 0.5                           # (tiles, blocks, 128)
    n_px, n_warps = mask.numel(), mask.numel() // 32
    prev = torch.zeros(mask.shape, device=mask.device)
    lit_hits, warp_lights, skip = 0, 0, []
    for s in range(1, n + 1):
        c = const.clone()
        c[21] = s
        count = shade_fused.deferred_kernel_reference(c, *dargs[1:], **dkw)[:, 3]
        hit = count > prev
        prev = count
        lit_hits += int((hit & mask).sum())
        runs = int((hit & mask).reshape(-1, 32).any(-1).sum())
        warp_lights += runs
        skip.append(1 - runs / n_warps)
    return (f"census: {n_px} pixels, lit share {float(mask.float().mean()):.4f}; (pixel, light) "
            f"hits {int(prev.sum())} ({lit_hits} on lit pixels) of {n_px * n} pairs; light "
            f"bodies evaluated by a full loop {n_px * n}, by the warp skip {32 * warp_lights} "
            f"({32 * warp_lights / max(n_px * n, 1):.4f}); share of warps that skip each light "
            f"{[round(x, 4) for x in skip]}")


def camera_path(cam, n):
    path, c = [], cam
    for _ in range(n):
        c = copy.deepcopy(c)
        c.rotate(0.0, 0.002, 0.0)
        path.append(c)
    return path


def run_frames(phase, pipe, path, want: dict[str, int], absent=()):
    """Render `path` with every launch count set to 0 just before and read
    just after; fail when a kernel of the path launched fewer times than
    `want`, or a kernel in `absent` launched at all (kernel I too, unless
    `want` names it). Returns (host ms per frame, launches)."""
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for c in path:
        t0 = time.perf_counter()
        pipe.render(c, collect_stats=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    for name, n in want.items():
        if launches[name] < n:
            fail(phase, f"kernel {name} launched {launches[name]} times in {len(path)} "
                 f"frames, want >= {n}")
    for name in (*absent, *[WIDE] * (WIDE not in want)):
        if launches[name]:
            fail(phase, f"kernel {name} launched {launches[name]} times, want none")
    return times, launches


def check_frame(phase, pipe, cam) -> str:
    img = pipe.render(cam)  # stats of this pose
    rgb = img.cpu().numpy()
    lit = float((rgb.max(-1) > 16).mean())
    avg = float(pipe.avg_luminance)
    if rgb.shape != (H, W, 3) or not math.isfinite(avg) or avg <= 0 or lit < 0.05:
        fail(phase, f"bad frame: shape {rgb.shape}, avg luminance {avg}, lit {lit:.3f}")
    return f"lit {lit:.3f}; avg luminance {avg:.5f} (finite); {pipe.last_stats}"


def fidelity(pipe, ref, cam) -> tuple[float, int]:
    """Frame rmse (uint8/255) of `pipe` against `ref` on the same pose and
    exposure carry."""
    prev = pipe.avg_luminance.clone()
    ref.avg_luminance = prev.clone()
    a = pipe.render(cam).cpu().numpy().astype(np.float64)
    pipe.avg_luminance = prev
    b = ref.render(cam, collect_stats=False).cpu().numpy().astype(np.float64)
    return float(np.sqrt(np.mean((a / 255.0 - b / 255.0) ** 2))), int((a != b).any(-1).sum())


def lights1k(dev, cam, knobs, base_knobs, measured, bounds) -> dict[str, int]:
    """The 1024-light cell: the JAX bench's lights1k scene with the default
    cell's sky and cache knobs, through the 1024-light path (kernels A, B, C,
    F, G; not D). Checks F and G against their plain versions on one frame's
    recorded inputs, times 16 frames, the passes, and the frame's fidelity.
    Adds F's and G's (max abs error, ms, plain ms) to `measured` and their
    bounds to `bounds`; returns the frames' launch counts."""
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.ops import env_resolve_cuda, envcache, lights_cuda
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    t0 = time.perf_counter()
    scene = stress_scene(*L1K_CELLS, 256, 80.0, n_lights=L1K_LIGHTS)
    cfg = RenderConfig(W, H, max_instances=2, max_lights=L1K_LIGHTS)
    l1k_knobs = dict(knobs, bin_cap=L1K_BIN_CAP, max_active_lights=L1K_LIGHTS)
    pipe = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps=TEX_CAPS, **l1k_knobs)
    torch.cuda.synchronize()
    if not (pipe.use_fused_gbuffer and pipe.light_tile == (TILE_H, TILE_W)
            and not pipe.use_fused_deferred and "EnvCache" in pipe.buffers):
        fail("scene-lights1k", "the pipeline on the card is not the 1024-light kernel path")
    with recording(lights_cuda, "point_lights_kernel") as light_calls, \
            recording(lights_cuda, "point_lights_tiled") as tiled_calls, \
            recording(env_resolve_cuda, "env_resolve") as env_calls:
        pipe.render(cam)
        torch.cuda.synchronize()
    if (len(light_calls), len(tiled_calls), len(env_calls)) != (1, 1, 1):
        fail("scene-lights1k", f"a frame made {len(light_calls)} light, {len(tiled_calls)} "
             f"tiled-light and {len(env_calls)} env-resolve calls, want 1, 1 and 1")
    (gargs, gkw), = light_calls
    tiled_call, = tiled_calls
    (fargs, _), = env_calls
    listed = gargs[0].cpu().numpy()
    say("scene-lights1k", f"stress scene {pipe.packed.tris.shape[0]} tris, "
        f"{pipe.packed.light_count} lights ({pipe.last_stats.visible_lights} visible), sky 256, "
        f"bin_cap {L1K_BIN_CAP}, max_active_lights {L1K_LIGHTS}, light_tile {pipe.light_tile}, "
        f"light_cap {pipe.light_cap}, env tile {pipe.env_tile}; culled lights per light tile "
        f"p50 {np.percentile(listed, 50):.0f} p99 {np.percentile(listed, 99):.0f} max "
        f"{listed.max()} of {listed.size} tiles; pipeline built in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- kernel G vs its plain version on the frame's inputs ----------------
    got = lights_cuda.point_lights_kernel(*gargs, **gkw)
    err_g, same = check_lights("kernel-lights", gargs, got,
                               lights_cuda.point_lights_kernel_reference(*gargs, **gkw))
    ms_g = cuda_ms(lambda: lights_cuda.point_lights_kernel(*gargs, **gkw), 20)
    alone_g = graph_ms(lambda: lights_cuda.point_lights_kernel(*gargs, **gkw), 20)
    plain_ms_g = cuda_ms(lambda: lights_cuda.point_lights_kernel_reference(*gargs, **gkw), 2)
    c = light_census(gargs, gkw, got[..., 3])
    if c["list_mismatches"] >= G_COUNTER_FRAC * same.size:
        fail("kernel-lights", f"{c['list_mismatches']} pixels whose plain cluster list "
             f"(cluster_light_lists_reference) admits another count than the kernel")
    # every input once, the (tiles, p, 4) output; the work this frame's data
    # needs (csrc/point_lights.cu, a sqrt or division counted as one): about
    # 100 flops of setup per pixel, 18 for the cluster sphere test per
    # distinct (tile, cluster) and list position walked up to its 32nd hit,
    # and 100 for the Cook-Torrance terms per admitted light of a pixel with
    # mask 1. The earlier bound charged the sphere test to every (pixel,
    # listed light) pair and the terms to every admitted light.
    n_bytes = nbytes(*gargs) + got.numel() * 4
    n_px = got.shape[0] * got.shape[1]
    bounds["point_lights"] = bound(n_bytes, n_px * 100 + c["tile_cluster_tests"] * 18
                                   + c["admitted_masked"] * 100)
    old_bound = bound(n_bytes, n_px * 100 + c["pairs"] * 18 + c["admitted"] * 100)
    EARLIER_BOUNDS["point_lights"] = old_bound[0]
    measured["point_lights"] = (err_g, ms_g, plain_ms_g, alone_g)
    say("kernel-lights", f"{tuple(gargs[3].shape)} G-buffer, rows {tuple(gargs[2].shape)}: ok, "
        f"{int((~same).sum())} hit-count mismatches of "
        f"{same.size}, max abs rgb diff {err_g:.3e} (rtol {G_RTOL}/atol {G_ATOL}), kernel "
        f"{ms_g:.4f} ms through its wrapper (CUDA events), the kernel alone {alone_g:.4f} ms "
        f"(CUDA graph replays), plain {plain_ms_g:.4f} ms, bound "
        f"{bounds['point_lights'][0]:.4f} ms "
        f"({bounds['point_lights'][1]}; the earlier bound over every (pixel, listed light) "
        f"pair {old_bound[0]:.4f} ms, {old_bound[1]}); census: {c['pairs']:.4g} (pixel, "
        f"listed light) pairs, {c['tile_cluster_tests']:.4g} (tile, cluster) sphere tests up "
        f"to the 32nd hit, {c['lane_tests']:.4g} lane tests of the kernel's (warp, cluster) "
        f"walks ({c['warp_groups']} walks over {c['warps']} warps, at most {c['most_keys']} "
        f"clusters in a warp); distinct clusters per tile p50 {c['clusters_p50']:.0f} max "
        f"{c['clusters_max']} ({c['clusters']} in all); {c['admitted']:.4g} admitted "
        f"({c['admitted_masked']:.4g} on pixels with mask 1), shaded in {c['shade_steps']:.4g} "
        f"warp steps (lane use {c['admitted_masked'] / (32 * max(1, c['shade_steps'])):.3f})")
    split = lights_pass_split(*tiled_call)
    say("kernel-lights", "point_lights_tiled on the frame's inputs, device ms by step (CUDA "
        "events): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    del got

    # ---- kernel F vs its plain version on the frame's inputs ----------------
    got = env_resolve_cuda.env_resolve(*fargs)
    err_f = check_close("kernel-env-resolve", got, env_resolve_cuda.env_resolve_reference(*fargs))
    ms_f = cuda_ms(lambda: env_resolve_cuda.env_resolve(*fargs), 20)
    alone_f, busy_f = device_ms(lambda: env_resolve_cuda.env_resolve(*fargs), 10,
                                "env_resolve")
    cold_f = cold_ms(lambda: env_resolve_cuda.env_resolve(*fargs), 20)
    plain_ms_f = cuda_ms(lambda: env_resolve_cuda.env_resolve_reference(*fargs), 3)
    # every input once (records, fracs, offsets, counts, and of the staged
    # pages the words the taps address), the (tiles, G, 4, blocks, 128)
    # output; about 36 flops per tap
    bounds["env_resolve"] = bound(
        nbytes(*fargs[:2], *fargs[3:]) + staged_read_bytes(*fargs[:4], 8) + nbytes(got),
        fargs[3].numel() * 36)
    measured["env_resolve"] = (err_f, ms_f, plain_ms_f, alone_f, cold_f)
    say("kernel-env-resolve", f"{tuple(fargs[3].shape)} taps, staged {tuple(fargs[2].shape)}: "
        f"ok (max abs diff {err_f:.3e}, rtol {F_RTOL}/atol {F_ATOL}), kernel {ms_f:.4f} ms "
        f"through its wrapper ({cold_f:.4f} ms with the L2 evicted before each call), the kernel "
        f"alone {alone_f:.4f} ms of {busy_f:.4f} ms of device "
        f"work (torch.profiler), "
        f"plain {plain_ms_f:.4f} ms, bound {bounds['env_resolve'][0]:.4f} ms "
        f"({bounds['env_resolve'][1]})")
    del got, gargs, fargs, light_calls, tiled_calls, tiled_call, env_calls

    # ---- the 1024-light path: A, B, C, F, G; never D ------------------------
    path = camera_path(cam, WARMUP + FRAMES)
    for c in path[:WARMUP]:
        pipe.render(c)
    times, launches = run_frames("frame-lights1k", pipe, path[WARMUP:], {
        "raster_interp": FRAMES, "fused_cover": 4 * FRAMES, "resolve_shade": FRAMES,
        "env_resolve": FRAMES, "point_lights": FRAMES})
    if launches["deferred_shade"]:
        fail("frame-lights1k", f"kernel D launched {launches['deferred_shade']} times")
    frame_line = check_frame("frame-lights1k", pipe, path[-1])
    say("frame-lights1k", f"1024-light path, {FRAMES} frames {W}x{H}: mean "
        f"{np.mean(times):.2f} ms, p50 {np.median(times):.2f} ms (host clock, synchronized per "
        f"frame); kernel launches {launches}; {frame_line}")
    per_pass = timed_passes(pipe, path[-1], 3)
    say("passes-lights1k", "1024-light path, mean device ms per pass (CUDA events): " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_pass.items()))
    wall, busy, n_act, top = profiled_frames(pipe, path[-1], 3)
    say("profile-lights1k", f"1024-light path, torch.profiler, 3 frames: wall {wall:.2f} ms/frame, "
        f"device busy {busy:.2f} ms/frame ({n_act:.0f} device activities), idle share "
        f"{1 - busy / wall:.3f}; top: " + "; ".join(f"{ms:.2f} ms {name[:60]}" for ms, name in top))

    # ---- against the all-plain pipeline (the dense 1024-light sweep) --------
    ref = DeferredRenderPipeline(scene, cfg, use_pallas=False, use_tex_kernel=False,
                                 device=dev, **l1k_knobs)
    with recording(envcache, "sample_env_tiled") as env_calls:
        rmse, ndiff = fidelity(pipe, ref, path[-1])
    st = pipe.last_stats
    counters = {k: getattr(st, k) for k in ("lights_truncated", "light_tile_overflow",
                                            "tex_approx_taps", "env_approx_taps")}
    (eargs, ekw), = env_calls   # the env taps' fallbacks by group, for the record
    by_group = envcache.sample_env_tiled(*eargs, **ekw)[2].sum((0, 1)).tolist()
    if rmse > RMSE_BAR or any(counters.values()):
        fail("fidelity-lights1k", f"frame rmse vs use_pallas=False, use_tex_kernel=False "
             f"{rmse:.6f} (bar {RMSE_BAR}); {counters} (all must be 0); env fallback taps by "
             f"group (env lo, env hi, BRDF LUT, sky, cascade) {by_group}")
    # with the JAX package's default knobs, for the record (not gated)
    jax_knobs = dict(base_knobs, bin_cap=L1K_BIN_CAP, max_active_lights=L1K_LIGHTS)
    pipe_j = DeferredRenderPipeline(scene, cfg, device=dev, **jax_knobs)
    pipe_j.avg_luminance = pipe.avg_luminance.clone()
    rmse_j, _ = fidelity(pipe_j, DeferredRenderPipeline(
        scene, cfg, use_pallas=False, use_tex_kernel=False, device=dev, **jax_knobs), path[-1])
    st_j = pipe_j.last_stats
    say("fidelity-lights1k", f"1024-light frame (tex_caps {TEX_CAPS}, brdf_lut_size "
        f"{BRDF_LUT}) rmse vs use_pallas=False, use_tex_kernel=False (the dense light sweep) "
        f"on the card {rmse:.6f} <= {RMSE_BAR}; {ndiff} pixels differ; {counters}; env "
        f"fallback taps by group {by_group}; "
        f"{st.visible_lights} visible lights; with the JAX default knobs (not gated): rmse "
        f"{rmse_j:.6f}, tex_approx_taps {st_j.tex_approx_taps}, env_approx_taps "
        f"{st_j.env_approx_taps}, light_tile_overflow {st_j.light_tile_overflow}")
    return launches


def write_asset_sources(src, scene) -> np.ndarray:
    """The textured stress cell's content as source files an artist would
    hand the importers: the terrain as OBJ/MTL with its albedo map as a PNG,
    and the sky's six faces as Radiance HDR. Returns the centroid that
    `import_model` takes off the vertices, so the imported model can be put
    back where the terrain stood."""
    from PIL import Image

    from direct12pbrrenderer_tpu_torch.resource.hdr import save_hdr

    model = scene.models[0].model
    mesh = model.mesh_resource.mesh
    v = mesh.vertex_array()
    tris = mesh.index_array().reshape(-1, 3) + 1          # OBJ indices start at 1
    f = np.repeat(tris, 3, axis=1)                        # v/vt/vn share the index
    lines = ["mtllib terrain.mtl",
             "\n".join(f"v {a:.9g} {b:.9g} {c:.9g}" for a, b, c in v["position"]),
             "\n".join(f"vt {a:.9g} {b:.9g}" for a, b in v["uv"]),
             "\n".join(f"vn {a:.9g} {b:.9g} {c:.9g}" for a, b, c in v["normal"]),
             "usemtl terrain",
             "\n".join("f {}/{}/{} {}/{}/{} {}/{}/{}".format(*t) for t in f.tolist())]
    (src / "terrain.obj").write_text("\n".join(lines) + "\n")
    (src / "terrain.mtl").write_text("newmtl terrain\nmap_Kd albedo.png\n")
    albedo = model.materials[0].textures["AlbedoMap"].texture
    Image.fromarray(albedo.mip_array_rgba(0)).save(src / "albedo.png")
    cube = src / "sky"
    cube.mkdir()
    for i, name in enumerate(("px", "nx", "py", "ny", "pz", "nz")):
        save_hdr(cube / f"{name}.hdr", scene.skybox.cubemap.faces[i].mip_array_rgba(0)[..., :3])
    # import_model's recentering: the mean of every triangle corner, summed
    # triangle by triangle in float64, then rounded to float32
    corners = v["position"][mesh.index_array()].reshape(-1, 3, 3)
    return (corners.sum(1).astype(np.float64).sum(0) / corners.shape[0] / 3).astype(np.float32)


def asset_auto(dev, cam, smi) -> int:
    """The asset-tree path with `tex_caps="auto"`: the textured stress cell's
    content written as source files, imported with the port's importers
    (BC1 albedo, BC6H sky), a Scene JSON dumped, the tree reloaded through a
    fresh ResourceLoader, then the pipeline with tex_caps="auto" and the
    cell's other knobs: its first frame runs the tap census (three poses,
    two depth-only rasters each: kernel H) and sizes the caches, then 16
    frames (kernels B, C, D at the sized caps, cascade and budgets). Holds
    the census with H to the census with the plain fold, the sized knobs to
    the recommend_* folds, one sized frame's B, C and D calls to their plain
    versions, and the frame to the all-plain pipeline. Returns kernel H's
    launches on the path."""
    import tempfile
    from pathlib import Path

    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.ops import (cover_cuda, envcache, resolve_shade_cuda,
                                                   shade_fused, texcache)
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer_tpu_torch.resource.loader import ResourceLoader
    from direct12pbrrenderer_tpu_torch.resource.resources import CubeMapResource, ModelResource
    from direct12pbrrenderer_tpu_torch.scene.scene import Scene, SceneModel
    from direct12pbrrenderer_tpu_torch.tools import tap_census

    phase = "asset-auto"
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        src, root = Path(tmp) / "src", Path(tmp) / "assets"
        src.mkdir()
        content = stress_scene(*ASSET_CELLS, 256, 80.0)
        t0 = time.perf_counter()
        centroid = write_asset_sources(src, content)
        t_write = time.perf_counter() - t0
        ld = ResourceLoader.set_instance(ResourceLoader(root))
        t0 = time.perf_counter()
        ld.import_model(src / "terrain.obj", "Asset/Terrain/Terrain")
        t_model = time.perf_counter() - t0
        t0 = time.perf_counter()
        ld.import_cubemap(src / "sky", "Asset/Sky/Procedural")
        t_cube = time.perf_counter() - t0
        scene = Scene("Asset/Scene/main")
        sm = SceneModel("terrain")
        sm.model_file_path = "Asset/Terrain/Terrain_Model"
        sm.translation = centroid                    # back where the terrain stood
        scene.add_model(sm)
        for light in content.lights:
            scene.add_light(light)
        scene.skybox_path = "Asset/Sky/Procedural"
        ld.dump_resource(scene)
        n_files = sum(1 for p in root.rglob("*") if p.is_file())
        tree_mb = sum(p.stat().st_size for p in root.rglob("*") if p.is_file()) / 1e6
        del content, ld

        # ---- reload through a fresh loader -----------------------------------
        t0 = time.perf_counter()
        ld = ResourceLoader.set_instance(ResourceLoader(root))
        scene = ld.load_resource(Scene, "Asset/Scene/main")
        t_load = time.perf_counter() - t0
    model = scene.models[0].model
    mesh = model.mesh_resource.mesh if model is not None else None
    albedo = model.materials[0].textures.get("AlbedoMap") if model is not None else None
    if (mesh is None or mesh.index_count != 6 * ASSET_CELLS[0] * ASSET_CELLS[1] or albedo is None
            or albedo.texture.mip_array_rgba(0).shape != (256, 256, 4)
            or not model.materials[0].get_parameter("UseAlbedoMap")
            or len(scene.lights) != 8 or scene.skybox is None
            or scene.skybox.cubemap.faces[0].mip_array_rgba(0).shape != (256, 256, 4)
            or not np.isfinite(scene.skybox.cubemap.faces[0].mip_array_rgba(0)).all()):
        fail(phase, "the reloaded asset tree lacks the terrain, its albedo map, the lights "
             "or the sky")
    say(phase, f"asset tree written by the port's importers on {smi}'s host: source files "
        f"{t_write:.2f} s, "
        f"import_model (OBJ {mesh.index_count // 3} tris, BC1 albedo) {t_model:.2f} s, "
        f"import_cubemap (six 256^2 HDR faces, BC6H) {t_cube:.2f} s; {n_files} files, "
        f"{tree_mb:.1f} MB; reloaded through a fresh ResourceLoader in {t_load:.2f} s: "
        f"{mesh.index_count // 3} tris, albedo {albedo.texture.width}x{albedo.texture.height} "
        f"({albedo.texture.format.name}, {albedo.texture.mip_levels} mips), "
        f"{len(scene.lights)} lights, sky {scene.skybox.cubemap.faces[0].width}^2 "
        f"(SH {np.asarray(scene.skybox.sh.as_array())[0, :3].round(4).tolist()}...)")

    # ---- tex_caps="auto": the census on the first render --------------------
    cfg = RenderConfig(W, H, max_instances=2)
    knobs = dict(tile_h=TILE_H, tile_w=TILE_W, bin_cap=BIN_CAP, atlas_max_dim=256,
                 brdf_lut_size=BRDF_LUT)
    pipe = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps="auto", **knobs)
    if not (pipe._auto_caps and pipe.use_pallas and pipe.use_fused_deferred):
        fail(phase, "the auto pipeline on the card is not the fused kernel path")
    recorded, real_census, census_s = [], tap_census.run_census, []

    def census_and_record(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_census(*args, **kw)
        torch.cuda.synchronize()
        census_s.append(time.perf_counter() - t)
        recorded.append(out)
        return out

    path = camera_path(cam, WARMUP + FRAMES)
    torch.cuda.synchronize()
    reset_launches()
    tap_census.run_census = census_and_record
    try:
        for c in path[:WARMUP]:           # the first render sizes the caches
            pipe.render(c)
    finally:
        tap_census.run_census = real_census
    h_census = read_launches()["raster_depth"]
    keep = read_launches()
    times, frame_launches = run_frames(phase, pipe, path[WARMUP:], {
        "fused_cover": 5 * FRAMES, "resolve_shade": FRAMES, "deferred_shade": FRAMES,
        "raster_interp": FRAMES})
    launches = {k: keep[k] + frame_launches[k] for k in KERNELS}
    if len(recorded) != 1 or h_census != 6:
        fail(phase, f"the first render ran {len(recorded)} censuses and launched kernel H "
             f"{h_census} times, want 1 census of 3 poses and 6 launches")
    for name in ("raster_depth", "fused_cover", "resolve_shade", "deferred_shade"):
        if not launches[name]:
            fail(phase, f"kernel {name} launched no time on the asset-auto path")
    censuses, caps, env_censuses = recorded[0]
    want = (caps[0], caps[1], texcache.recommend_budget(censuses),
            texcache.recommend_block_caps(censuses))
    want_env = envcache.recommend_budget(env_censuses)
    if (pipe.tex_caps, pipe.env_budget, pipe.tex_cascade) != (want, want_env, (12, 8, 1)):
        fail(phase, f"sized knobs tex_caps {pipe.tex_caps}, env_budget {pipe.env_budget}, "
             f"tex_cascade {pipe.tex_cascade}; the census's recommend_* give {want}, "
             f"{want_env}, (12, 8, 1)")
    stats_line = check_frame(phase, pipe, path[-1])

    # ---- the census with kernel H against the census with the plain fold ----
    plain = []
    for use_pallas in (True, False):
        pipe.use_pallas = use_pallas      # the census reads the pipeline's raster knob
        plain.append((tap_census.census_for_pose(pipe, path[0]),
                      tap_census.env_census_for_pose(pipe, path[0])))
    pipe.use_pallas = True
    if plain[0] != plain[1] or plain[0] != (censuses[0], env_censuses[0]):
        fail(phase, f"the first pose's census with kernel H {plain[0]} differs from the "
             f"census with the plain fold {plain[1]} or from the sizing census "
             f"{(censuses[0], env_censuses[0])}")

    # ---- one sized frame's B, C, D calls held to their plain versions ------
    with recording(cover_cuda, "fused_cover") as cover_calls, \
            recording(resolve_shade_cuda, "resolve_shade") as shade_calls, \
            recording(shade_fused, "deferred_kernel") as deferred_calls:
        pipe.render(path[-1], collect_stats=False)
        torch.cuda.synchronize()
    held = []
    for name, calls in (("fused_cover", cover_calls), ("resolve_shade", shade_calls),
                        ("deferred_shade", deferred_calls)):
        errs = [hold_call(phase, name, args, kw) for args, kw in calls]
        held.append(f"{name} {len(errs)} calls, max_abs_err {max(errs):.3e}")
    cover_shapes = [(tuple(a[0].shape), max(a[2]), a[3]) for a, _ in cover_calls]
    (sargs, skw), = shade_calls
    (dargs, dkw), = deferred_calls
    staged_c, staged_d = tuple(sargs[2].shape), tuple(dargs[4].shape)
    del cover_calls, shade_calls, deferred_calls, sargs, dargs

    wall, busy, n_act, top = profiled_frames(pipe, path[-1], 8)
    ref = DeferredRenderPipeline(scene, cfg, use_pallas=False, use_tex_kernel=False,
                                 device=dev, **knobs)
    rmse, ndiff = fidelity(pipe, ref, path[-1])
    if rmse > RMSE_BAR:
        fail(phase, f"auto-sized frame rmse vs use_pallas=False, use_tex_kernel=False "
             f"{rmse:.6f} > {RMSE_BAR}; {pipe.last_stats}; sized tex_caps {pipe.tex_caps}, "
             f"env_budget "
             f"{pipe.env_budget}; census {censuses} {env_censuses}")
    say(phase, f"census (3 poses over a 30 degree yaw sweep, kernel H for each raster) "
        f"{census_s[0]:.2f} s on {smi}: per pose texture lo max/p99/row_p999, hi max/p99/"
        f"row_p999, tile_total max; env group max, tile_total max: " + "; ".join(
            f"{c['lo']['max']}/{c['lo']['p99']}/{c['lo']['row_p999']}, "
            f"{c['hi']['max']}/{c['hi']['p99']}/{c['hi']['row_p999']}, "
            f"{c['tile_total']['max']}; {e['group']['max']}, {e['tile_total']['max']}"
            for c, e in zip(censuses, env_censuses))
        + f"; sized tex_caps {pipe.tex_caps}, env_budget {pipe.env_budget}, tex_cascade "
        f"{pipe.tex_cascade} (= the recommend_* folds); the first pose's census with kernel "
        f"H equals the census with the plain fold in every count; covers per frame "
        f"(planes, cap, block_cap) {cover_shapes}; staged pages C {staged_c}, D {staged_d}")
    say(phase, f"auto-sized path, {FRAMES} frames {W}x{H}: mean {np.mean(times):.2f} ms, "
        f"p50 {np.median(times):.2f} ms (host clock, synchronized per frame) on {smi}; kernel "
        f"launches on the path (the census's H included) {launches}; one frame's kernel "
        f"calls held to their plain versions at the kernels line's bars: " + "; ".join(held)
        + f"; torch.profiler over 8 frames: wall {wall:.2f} ms/frame, device busy {busy:.2f} "
        f"ms/frame ({n_act:.0f} device activities), idle share {1 - busy / wall:.3f}; top: "
        + "; ".join(f"{ms:.2f} ms {name[:60]}" for ms, name in top))
    say(phase, f"auto-sized frame rmse vs use_pallas=False, use_tex_kernel=False on {smi} "
        f"{rmse:.6f} <= {RMSE_BAR}; {ndiff} pixels differ; {stats_line}")
    del pipe, ref, scene
    torch.cuda.empty_cache()
    return launches["raster_depth"]


def light_census(args, kw, counter) -> dict[str, int]:
    """Kernel G's work on one frame, counted on the card from the plain
    versions of its steps: (pixel, listed light) pairs, the sphere tests of
    one walk per distinct (tile, cluster) up to its 32nd hit, the lane tests
    of the kernel's walks (one per distinct cluster of each warp, 32 lanes a
    step; one staging window per tile at caps up to 1024), the distinct
    clusters per tile, the admitted lights (all, and of pixels with mask 1),
    the shading loop's warp steps (each warp as long as its longest lit
    list), and the pixels whose list admits another count than the kernel's
    `counter` (tiles, p)."""
    from direct12pbrrenderer_tpu_torch.ops import lights_cuda

    counts, const, rows_t, gb_t = args
    tiles, p, _ = gb_t.shape
    dev = gb_t.device
    key = lights_cuda.pixel_cluster_keys(const, gb_t, **kw)
    pos, n = lights_cuda.cluster_light_lists_reference(*args, **kw)
    listed = torch.clamp(counts, max=rows_t.shape[-1]).long()[:, None].expand(tiles, p)
    walked = torch.where(n == 32, pos[..., 31].long() + 1, listed)
    tile = torch.arange(tiles, device=dev)[:, None]
    warp = torch.arange(p, device=dev)[None, :] // 32
    n_warps = -(-p // 32)

    def groups(ids):  # distinct ids, each with its walk length
        u, inv = torch.unique(ids, return_inverse=True)
        return u, torch.zeros(u.numel(), dtype=torch.long, device=dev).scatter_(
            0, inv.flatten(), walked.flatten())

    per_tile, w_tile = groups(tile * lights_cuda.KEYS_PER_TILE + key)
    per_tile = torch.bincount(per_tile // lights_cuda.KEYS_PER_TILE, minlength=tiles)
    u_warp, w_warp = groups((tile * n_warps + warp) * lights_cuda.KEYS_PER_TILE + key)
    keys_per_warp = torch.bincount(u_warp // lights_cuda.KEYS_PER_TILE)
    mask = gb_t[..., 9] > 0.5
    # the shading loop: a warp steps as often as its longest lit pixel's list
    lit_n = torch.nn.functional.pad(torch.where(mask, n, 0), (0, n_warps * 32 - p))
    shade_steps = int(lit_n.view(tiles, n_warps, 32).max(-1).values.sum())
    return {"pairs": p * int(listed[:, 0].sum()), "tile_cluster_tests": int(w_tile.sum()),
            "shade_steps": shade_steps,
            "lane_tests": 32 * int(((w_warp + 31) // 32).sum()), "warp_groups": u_warp.numel(),
            "warps": tiles * n_warps, "most_keys": int(keys_per_warp.max()),
            "clusters": int(per_tile.sum()),
            "clusters_p50": float(per_tile.float().median()),
            "clusters_max": int(per_tile.max()), "admitted": int(n.long().sum()),
            "admitted_masked": int(n[mask].long().sum()),
            "list_mismatches": int((n.float() != counter).sum())}


def lights_pass_split(args, kw) -> dict[str, float]:
    """Device ms of each step of `point_lights_tiled` on one call's inputs
    (CUDA events), from the steps it runs (`point_lights_steps`: the tile
    light lists, the staging of the listed light rows, the G-buffer tiling,
    the const vector, kernel G and the untiling); then the whole call."""
    from direct12pbrrenderer_tpu_torch.ops import lights_cuda as lc

    steps = lc.point_lights_steps(*args, **kw)
    done = {}
    for name, step in steps:
        done[name] = step(done)
    ms = {name: cuda_ms(lambda: step(done), 10) for name, step in steps}
    return {**ms, "whole call": cuda_ms(lambda: lc.point_lights_tiled(*args, **kw), 10)}


def cover_census(pages, act, block_cap: int):
    """Kernel B's work on one call: the live candidates of each (tile,
    group) item (each row's distinct active pages, at most block_cap) and
    whether the item has no active pixel. -> ((tiles, g) int, (tiles, g)
    bool)."""
    from direct12pbrrenderer_tpu_torch.ops import cover_cuda

    srt = torch.where(act, pages, cover_cuda.SENTINEL).sort(-1).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[..., 1:] = srt[..., 1:] != srt[..., :-1]
    per_row = (new & (srt != cover_cuda.SENTINEL)).sum(-1).clamp(max=block_cap)
    return per_row.sum(-1), ~act.flatten(2).any(-1)


def cover_bytes_needed(cargs, got, empty) -> int:
    """The bytes one page cover (kernel B, or I at a cap above 128) must
    move: act of every item in, the four outputs `got` out, and the pages of
    the items with an active pixel only (`empty` from `cover_census`): an
    empty item's outputs are 0 whatever its pages hold (the TPU kernel's
    whole-tile gate)."""
    pages, act = cargs[:2]
    return nbytes(act, *got) + int((~empty).sum()) * pages[0, 0].numel() * pages.element_size()


def fold_census(setup, bins, width, height, tile_h, tile_w) -> dict[str, int]:
    """The depth fold's work on this frame, counted on the card from the
    AABBs, the bin lists and the per-tile list limits of kernels A and H
    (defaults of `resolve_caps`): (pixel, listed candidate) pairs in all;
    those a chunk-level band skip leaves (every listed entry of a 128-entry
    chunk in which some entry's y-extents meet an 8-row band, times the
    band's pixels: the earlier fold's only reject); those the per-warp AABB
    reject leaves (candidates meeting the band and a warp's 16x8 rectangle,
    times its pixels); and those whose
    pixel lies inside the candidate's integer AABB, the only pairs a
    candidate can cover. Also the longest list, the most survivors of any
    band and of any warp rectangle, the kernels' work items at their slice
    length ((tile, band, slice) items in all and bands split across blocks),
    and the listed entries and the distinct triangles among them, the rows
    the kernels read."""
    from direct12pbrrenderer_tpu_torch.ops import raster_cuda

    num_tiles, cap = bins.ids.shape
    cap_small, hot_k = raster_cuda.resolve_caps(cap, num_tiles, None, None)
    limits = raster_cuda.tile_limits(bins.counts, cap, cap_small, hot_k)
    dev = bins.ids.device
    bands = -(-tile_h // 8)
    slices = (limits.long() + raster_cuda.SLICE - 1).div(raster_cuda.SLICE,
                                                         rounding_mode="floor").clamp(min=1)
    listed = ((torch.arange(cap, device=dev)[None, :] < limits[:, None].long())
              & (bins.ids >= 0))
    xmin, ymin, xmax, ymax = raster_cuda.raster_extents(setup)[
        bins.ids.clamp(min=0).long()].unbind(-1)                   # each (tiles, cap)
    t = torch.arange(num_tiles, device=dev)[:, None]
    ox = (t % (width // tile_w) * tile_w).float()
    oy = (t // (width // tile_w) * tile_h).float()

    def span(lo, hi, a, b):  # integer pixels of [lo, hi) inside [a, b)
        return (torch.minimum(hi, b) - torch.maximum(lo, a)).clamp(min=0).long()

    out = {"all": tile_h * tile_w * int(listed.sum()),
           "inside": int((span(xmin, xmax, ox, ox + tile_w) * span(ymin, ymax, oy, oy + tile_h)
                          * listed).sum()),
           "band_skip": 0, "warp_reject": 0, "longest_list": int(limits.max()),
           "slice": raster_cuda.SLICE, "items": bands * int(slices.sum()),
           "split_bands": bands * int((slices > 1).sum()),
           "listed": int(listed.sum()),
           "distinct": int(torch.unique(bins.ids[listed]).numel()),
           "most_band_survivors": 0, "most_warp_survivors": 0}
    for y0 in range(0, tile_h, 8):
        rows = min(8, tile_h - y0)
        lo, hi = oy + y0, oy + y0 + rows
        meets_y = listed & (ymin < hi) & (ymax > lo)
        chunk_hit = meets_y.view(num_tiles, -1, 128).any(-1)
        per_chunk = listed.view(num_tiles, -1, 128).sum(-1)
        out["band_skip"] += rows * tile_w * int((per_chunk * chunk_hit).sum())
        band = meets_y & (xmin < ox + tile_w) & (xmax > ox)
        out["most_band_survivors"] = max(out["most_band_survivors"], int(band.sum(1).max()))
        for x0 in range(0, tile_w, 16):
            x1 = min(x0 + 16, tile_w)
            warp = (band & (xmin < ox + x1) & (xmax > ox + x0)).sum(1)
            out["warp_reject"] += rows * (x1 - x0) * int(warp.sum())
            out["most_warp_survivors"] = max(out["most_warp_survivors"], int(warp.max()))
    return out


def census_line(c: dict[str, int]) -> str:
    return (f"(pixel, listed candidate) pairs: all {c['all']:.4g}, after a per-chunk band skip "
            f"{c['band_skip']:.4g}, after the warp reject {c['warp_reject']:.4g}, inside the "
            f"AABB {c['inside']:.4g}; longest list {c['longest_list']}, most survivors of a "
            f"band {c['most_band_survivors']}, of a 16x8 warp rectangle "
            f"{c['most_warp_survivors']}; work items at slices of {c['slice']} entries "
            f"{c['items']}, bands split across blocks {c['split_bands']}; {c['listed']} listed "
            f"entries of {c['distinct']} distinct triangles")


def fold_read_bytes(census, bins) -> int:
    """Bytes that kernels A's and H's fold must read on this frame: the bin
    counts (the per-tile list limits come from them), each listed entry's id
    once, and 20 words of each distinct listed triangle's row once (its 16
    raster floats and its AABB); a triangle no list holds is never read."""
    return nbytes(bins.counts) + census["listed"] * 4 + census["distinct"] * 20 * 4


def raster_depth_stage(phase, setup, bins, rows64, width, height, census, smi, measured,
                       bounds) -> int:
    """Kernel H on the default frame's geometry: the depth-only raster stage
    `stages.rasterize(use_pallas=True)` (its path, with the launch counts set
    to 0 just before and read just after), then H against its plain version
    and against kernel A's ids and depths, bit for bit. Returns H's launches
    on the path."""
    from direct12pbrrenderer_tpu_torch.ops import raster_cuda
    from direct12pbrrenderer_tpu_torch.pipeline import stages

    torch.cuda.synchronize()
    reset_launches()
    got = stages.rasterize(setup, bins, width, height, TILE_H, TILE_W, True)
    torch.cuda.synchronize()
    n_h = read_launches()["raster_depth"]
    if n_h != 1:
        fail(phase, f"stages.rasterize(use_pallas=True) launched kernel H {n_h} times, want 1")
    args = (setup, bins, width, height, TILE_H, TILE_W)
    err, _ = compare(phase, got, raster_cuda.rasterize_depth_reference(*args))
    ids_a, z_a, _ = raster_cuda.rasterize_interp(setup, bins, rows64, width, height, TILE_H,
                                                 TILE_W)
    compare(phase, got, (ids_a, z_a))
    del ids_a, z_a
    ms = cuda_ms(lambda: raster_cuda.rasterize_depth(*args), 20)
    alone_ms, busy_ms = device_ms(lambda: raster_cuda.rasterize_depth(*args), 10,
                                  "raster_depth")
    plain_ms = cuda_ms(lambda: raster_cuda.rasterize_depth_reference(*args), 2)
    # 2 words out per pixel and the fold's reads; 23 flops per (pixel,
    # candidate) pair whose pixel lies inside the candidate's AABB (kernel
    # A's fold without the winner's interpolation)
    bounds["raster_depth"] = bound(width * height * 2 * 4 + fold_read_bytes(census, bins),
                                   census["inside"] * 23)
    measured["raster_depth"] = (err, ms, plain_ms, alone_ms)
    say(phase, f"stages.rasterize(use_pallas=True) on the default {width}x{height} frame "
        f"({setup.edges.shape[0]} tris): kernel H launched {n_h}; ids and z bit-equal to its "
        f"plain version and to kernel A's; kernel through its wrapper {ms:.4f} ms (CUDA "
        f"events; device busy {busy_ms:.4f} ms of it, torch.profiler), the kernel alone "
        f"{alone_ms:.4f} ms (torch.profiler), plain "
        f"{plain_ms:.4f} ms, bound {bounds['raster_depth'][0]:.4f} ms "
        f"({bounds['raster_depth'][1]}) on {smi}; {census_line(census)}")
    return n_h


def planar_tex_cells(dev, scene, cfg, cam, knobs, pipe, cover_calls, measured,
                     bounds) -> dict[str, int]:
    """The planar texture-cache, cap-156 and anisotropic configurations of
    the textured stress cell. Checks kernel A at the 24x160 tile, E and I
    against their plain versions (and I's plain version against B at caps
    up to 128 on the default frame's recorded covers), times each path's
    frames, and holds each frame against its all-plain pipeline. Adds E's
    and I's numbers to `measured` and `bounds`; returns their launches on
    their paths."""
    from direct12pbrrenderer_tpu_torch.ops import (atlas_resolve_cuda, cover_cuda, cover_two,
                                                   raster_cuda, texcache)
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    t0 = time.perf_counter()
    ptex_knobs = dict(knobs, tile_h=PTEX_TILE[0], tile_w=PTEX_TILE[1])
    ptex = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps=TEX_CAPS, **ptex_knobs)
    torch.cuda.synchronize()
    if not (ptex.use_pallas and ptex.use_tex_kernel and not ptex.use_fused_gbuffer
            and not ptex.use_fused_deferred and "EnvCache" in ptex.buffers):
        fail("frame-planar-tex", "the pipeline on the card is not the planar texture-cache "
             "kernel path")

    # ---- kernel A at the 24x160 raster tile --------------------------------
    setup, bins, rows64, _ = frame_inputs(ptex, cam)
    args = (setup, bins, rows64, ptex.render_w, ptex.render_h, *PTEX_TILE)
    err, nmis = compare("kernel-frame-160", raster_cuda.rasterize_interp(*args),
                        raster_cuda.rasterize_interp_reference(*args))
    say("kernel-frame-160", f"{W}x{H} at tile {PTEX_TILE[0]}x{PTEX_TILE[1]} "
        f"({bins.ids.shape[0]} tiles, bin counts max {int(bins.counts.max())}): bit-equal (id "
        f"mismatches {nmis}, max_abs_err {err:.3e}), kernel "
        f"{cuda_ms(lambda: raster_cuda.rasterize_interp(*args), 10):.4f} ms")
    del setup, bins, rows64, args

    # ---- kernel E vs its plain version on one planar-tex frame's inputs ----
    with recording(atlas_resolve_cuda, "atlas_resolve") as e_calls:
        ptex.render(cam)
        torch.cuda.synchronize()
    (eargs, ekw), = e_calls
    got = atlas_resolve_cuda.atlas_resolve(*eargs, **ekw)
    want = atlas_resolve_cuda.atlas_resolve_reference(*eargs, **ekw)
    err_e = check_close("kernel-atlas-resolve", got, want)
    ms_e = cuda_ms(lambda: atlas_resolve_cuda.atlas_resolve(*eargs, **ekw), 20)
    alone_e, busy_e = device_ms(lambda: atlas_resolve_cuda.atlas_resolve(*eargs, **ekw), 10,
                                "atlas_resolve")
    cold_e = cold_ms(lambda: atlas_resolve_cuda.atlas_resolve(*eargs, **ekw), 20)
    plain_ms_e = cuda_ms(lambda: atlas_resolve_cuda.atlas_resolve_reference(*eargs, **ekw), 3)
    off, cnts, staged, rec = eargs[:4]
    # every input once (offsets, counts, records, fracs, trilinear fracs, and
    # of the staged pages the words the taps address), the (tiles, 5, 4,
    # blocks, 128) output; about 80 flops per group tap (unpack, scale, blend)
    bounds["atlas_resolve"] = bound(
        nbytes(off, cnts, *eargs[3:]) + staged_read_bytes(off, cnts, staged, rec, 4)
        + nbytes(got), rec.numel() * 80)
    measured["atlas_resolve"] = (err_e, ms_e, plain_ms_e, alone_e, cold_e)
    say("kernel-atlas-resolve", f"{tuple(rec.shape)} taps, staged {tuple(staged.shape)}, "
        f"cache tile {ptex.env_tile}: ok (max abs diff {err_e:.3e}, bit-equal "
        f"{bool(torch.equal(got, want))}; bar rtol {F_RTOL}/atol {F_ATOL}), kernel {ms_e:.4f} "
        f"ms through its wrapper ({cold_e:.4f} ms with the L2 evicted before each call), the "
        f"kernel alone {alone_e:.4f} ms of {busy_e:.4f} ms of device "
        f"work (torch.profiler), plain {plain_ms_e:.4f} ms, "
        f"bound {bounds['atlas_resolve'][0]:.4f} ms ({bounds['atlas_resolve'][1]})")
    del got, want, eargs, e_calls, off, cnts, staged, rec

    # ---- kernel I: kernel B's launch at cap 156, the cap-156 frame's lo half -
    cap = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps=CAP156, **knobs)
    with recording(cover_cuda, "fused_cover") as calls:
        cap.render(cam)
        torch.cuda.synchronize()
    wide = [c for c in calls if max(c[0][2]) > cover_cuda.WIDE_CAP]
    if (len(calls), len(wide)) != (4, 1):
        fail("kernel-cover-two", f"a cap-156 frame made {len(calls)} cover calls, "
             f"{len(wide)} of them at a cap above {cover_cuda.WIDE_CAP}: want 4 and 1")
    (wargs, wkw), = wide
    pages, act, caps, block_cap = wargs

    def cover_i():
        return cover_cuda.fused_cover(*wargs, **wkw)

    got = cover_i()
    for g_, w_, what in zip(got, texcache._cover_and_match_2level(*wargs, **wkw),
                            ("list", "count", "slot", "covered")):
        if not torch.equal(g_, w_):
            fail("kernel-cover-two", f"{what} differs from the plain two-kernel route")
    ms_i = cuda_ms(cover_i, 20)
    cold_i = cold_ms(cover_i, 20)
    alone_i, busy_i = device_ms(cover_i, 10, "fused_cover")
    ops_i = only_kernel("kernel-cover-two", cover_i, "fused_cover")
    plain_ms_i = cuda_ms(lambda: texcache._cover_and_match_2level(*wargs, **wkw), 3)
    live, empty = cover_census(pages, act, block_cap)
    call_bytes = cover_bytes_needed(wargs, got, empty)
    bounds[WIDE] = bound(call_bytes)
    measured[WIDE] = (0.0, ms_i, plain_ms_i, alone_i, cold_i)
    # the distinct pages of each tile's lo half (unclamped), beside the cap
    cand, slot_a = cover_two.block_cover_reference(pages, act, block_cap)
    flat = cand.reshape(*cand.shape[:2], -1)
    max_lo = int(texcache._distinct_by_sort(flat, flat.shape[-1])[1].max())
    # the slot half of the TPU's pix_match as one PyTorch call (the covered
    # half and the unmatched pixels' slot 0 are not in it): for the record
    cap_arr = torch.tensor(caps, dtype=torch.int32, device=dev)[None, :]
    slot_b = texcache._distinct_by_sort(flat, max(caps), cap_arr)[2].reshape(cand.shape)
    idx = slot_a.clamp(0, block_cap - 1).long()
    gather_ms = cuda_ms(lambda: torch.gather(slot_b, -1, idx), 20)
    # kernel I's plain version against kernel B on the default frame's four
    # covers (caps <= 128)
    for cargs, ckw in cover_calls:
        out_b = cover_cuda.fused_cover(*cargs, **ckw)
        out_i = texcache._cover_and_match_2level(*cargs, **ckw)
        for g_, w_, what in zip(out_i, out_b, ("list", "count", "slot", "covered")):
            if not torch.equal(g_, w_):
                fail("kernel-cover-two", f"two-kernel plain route vs kernel B: {what} differs")
    say("kernel-cover-two", f"lo-half cover of the cap-156 frame ({tuple(pages.shape)}, "
        f"caps {caps}, block_cap {block_cap}; {float(act.float().mean()):.3f} active; live "
        f"candidates per item p50 {float(live.float().median()):.0f} max {int(live.max())}, "
        f"empty items {float(empty.float().mean()):.3f}; distinct pages per tile max "
        f"{max_lo} of cap {CAP156[0]}): one launch of kernel B's body at cap {max(caps)}, all "
        f"four outputs bit-equal to the plain two-kernel route; {ms_i:.4f} ms through its "
        f"wrapper (CUDA events; {cold_i:.4f} ms with the L2 evicted before each call), the "
        f"kernel alone {alone_i:.4f} ms of {busy_i:.4f} ms of device work (torch.profiler), "
        f"plain {plain_ms_i:.4f} ms, bound {bounds[WIDE][0]:.4f} ms ({bounds[WIDE][1]}: act, "
        f"outputs and the pages of non-empty items, {call_bytes / 1e6:.1f} MB); one call "
        f"dispatches {ops_i} and traces only its kernel; planes' strides "
        f"{plane_layouts(wargs[:2])}; torch.gather of the slot half alone {gather_ms:.4f} ms "
        f"(not the whole function: library_ms null); plain two-kernel route vs kernel B on "
        f"the default frame's {len(cover_calls)} covers (caps <= 128): all four outputs "
        f"bit-equal")
    del got, cand, slot_a, flat, slot_b, idx, calls, wide, wargs, pages, act

    # ---- the planar texture-cache path: A, B, E, F -------------------------
    path = camera_path(cam, 1 + PTEX_FRAMES)
    ptex.render(path[0])
    times, launches = run_frames("frame-planar-tex", ptex, path[1:], {
        "raster_interp": PTEX_FRAMES, "fused_cover": 4 * PTEX_FRAMES,
        "atlas_resolve": PTEX_FRAMES, "env_resolve": PTEX_FRAMES},
        absent=("resolve_shade", "deferred_shade", "point_lights", "raster_depth"))
    out = {"atlas_resolve": launches["atlas_resolve"]}
    frame_line = check_frame("frame-planar-tex", ptex, path[-1])
    say("frame-planar-tex", f"planar texture-cache path, tile {PTEX_TILE[0]}x{PTEX_TILE[1]} "
        f"(cache tile {ptex.env_tile}), {PTEX_FRAMES} frames {W}x{H}: mean "
        f"{np.mean(times):.2f} ms, p50 {np.median(times):.2f} ms (host clock, synchronized per "
        f"frame); kernel launches {launches}; {frame_line}; pipeline built in "
        f"{time.perf_counter() - t0:.2f} s with the checks above")
    per_pass = timed_passes(ptex, path[-1], 2)
    say("passes-planar-tex", "planar texture-cache path, mean device ms per pass (CUDA "
        "events): " + ", ".join(f"{k} {v:.2f}" for k, v in per_pass.items()))
    wall, busy, n_act, top = profiled_frames(ptex, path[-1], 2)
    say("profile-planar-tex", f"planar texture-cache path, torch.profiler, 2 frames: wall "
        f"{wall:.2f} ms/frame, device busy {busy:.2f} ms/frame ({n_act:.0f} device "
        f"activities), idle share {1 - busy / wall:.3f}; top: " + "; ".join(
            f"{ms:.2f} ms {name[:60]}" for ms, name in top))
    ref = DeferredRenderPipeline(scene, cfg, use_pallas=False, use_tex_kernel=False,
                                 device=dev, **ptex_knobs)
    rmse, ndiff = fidelity(ptex, ref, path[-1])
    st = ptex.last_stats
    counters = {k: getattr(st, k) for k in ("bin_overflow", "tex_approx_taps",
                                            "env_approx_taps", "lights_truncated",
                                            "light_tile_overflow")}
    if rmse > RMSE_BAR or any(counters.values()):
        fail("fidelity-planar-tex", f"frame rmse vs use_pallas=False, use_tex_kernel=False "
             f"{rmse:.6f} (bar {RMSE_BAR}); {counters} (all must be 0)")
    say("fidelity-planar-tex", f"planar texture-cache frame (tex_caps {TEX_CAPS}, "
        f"brdf_lut_size {BRDF_LUT}) rmse vs use_pallas=False, use_tex_kernel=False at tile "
        f"{PTEX_TILE[0]}x{PTEX_TILE[1]} on the card {rmse:.6f} <= {RMSE_BAR}; {ndiff} pixels "
        f"differ; {counters}")
    del ptex, ref

    # ---- the cap-156 frame: B four times, one of them wide (kernel I) ---------
    _, launches = run_frames("frame-cap156", cap, [cam], {
        "raster_interp": 1, "fused_cover": 4, WIDE: 1, "resolve_shade": 1,
        "deferred_shade": 1}, absent=("atlas_resolve", "env_resolve"))
    if (launches["fused_cover"], launches[WIDE]) != (4, 1):
        fail("frame-cap156", f"kernel launches {launches}, want fused_cover 4, {WIDE} 1")
    out[WIDE] = launches[WIDE]
    rmse, ndiff = fidelity(cap, pipe, cam)
    st = cap.last_stats
    say("frame-cap156", f"default path with tex_caps {CAP156}, one frame: kernel launches "
        f"{launches}; vs the default frame (tex_caps {TEX_CAPS}) of the same pose: {ndiff} "
        f"pixels differ, rmse {rmse:.6f} (bit-equal expected while no lo-half cover exceeds "
        f"{TEX_CAPS[0]} pages: max {max_lo}); tex_approx_taps {st.tex_approx_taps}, "
        f"env_approx_taps {st.env_approx_taps}")
    if max_lo <= TEX_CAPS[0] and ndiff:
        fail("frame-cap156", f"{ndiff} pixels differ although no cover exceeds {TEX_CAPS[0]}")
    del cap

    # ---- the anisotropic filter: A, B (env), F; no E --------------------------
    aniso = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps=TEX_CAPS,
                                   texture_filter="anisotropic", **knobs)
    if aniso.use_fused_gbuffer or not aniso.use_tex_kernel:
        fail("frame-aniso", "the anisotropic pipeline is not the planar path")
    apath = camera_path(cam, 1 + ANISO_FRAMES)
    aniso.render(apath[0])
    times, launches = run_frames("frame-aniso", aniso, apath[1:], {
        "raster_interp": ANISO_FRAMES, "fused_cover": ANISO_FRAMES,
        "env_resolve": ANISO_FRAMES},
        absent=("atlas_resolve", "resolve_shade", "deferred_shade"))
    say("frame-aniso", f"texture_filter=anisotropic (tile {TILE_H}x{TILE_W}), {ANISO_FRAMES} "
        f"frames: mean {np.mean(times):.2f} ms, p50 {np.median(times):.2f} ms; kernel launches "
        f"{launches}; {check_frame('frame-aniso', aniso, apath[-1])}")
    ref = DeferredRenderPipeline(scene, cfg, use_pallas=False, use_tex_kernel=False,
                                 texture_filter="anisotropic", device=dev, **knobs)
    rmse, ndiff = fidelity(aniso, ref, apath[-1])
    if rmse > RMSE_BAR or aniso.last_stats.env_approx_taps:
        fail("fidelity-aniso", f"frame rmse vs the all-plain anisotropic frame {rmse:.6f} "
             f"(bar {RMSE_BAR}); env_approx_taps {aniso.last_stats.env_approx_taps}")
    say("fidelity-aniso", f"anisotropic frame rmse vs use_pallas=False, use_tex_kernel=False "
        f"(anisotropic) on the card {rmse:.6f} <= {RMSE_BAR}; {ndiff} pixels differ; "
        f"env_approx_taps {aniso.last_stats.env_approx_taps}")
    del aniso, ref
    torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    from direct12pbrrenderer_tpu_torch.ops import (
        cover_cuda,
        gbuffer,
        raster,
        raster_cuda,
        resolve_shade_cuda,
        shade_fused,
    )
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    build_kernels()

    # ---- kernel A vs plain version, random triangles, two-pass split -----
    w, h, cap = 256, 192, 512
    clip, tris, payload = random_triangles(2500, 3, dev)
    setup = raster.setup_triangles(clip, tris, torch.ones(tris.shape[0], dtype=torch.bool,
                                                          device=dev), w, h)
    bins = raster.bin_triangles(setup, h // TILE_H, w // TILE_W, TILE_H, TILE_W, cap)
    rows64 = raster_cuda.pack_rows64(setup, payload)
    n_over = int((bins.counts > 128).sum())
    if n_over < 2:
        fail("kernel-random", f"scene does not exercise the two-pass split ({n_over})")
    caps = dict(cap_small=128, hot_k=max(1, n_over // 2))
    args = (setup, bins, rows64, w, h, TILE_H, TILE_W)
    err, nmis = compare("kernel-random", raster_cuda.rasterize_interp(*args, **caps),
                        raster_cuda.rasterize_interp_reference(*args, **caps))
    say("kernel-random", f"{w}x{h} 2500 tris cap {cap} cap_small 128 hot_k {caps['hot_k']} "
        f"of {n_over} overfull: bit-equal (id mismatches {nmis}, max_abs_err {err:.3e}), kernel "
        f"{cuda_ms(lambda: raster_cuda.rasterize_interp(*args, **caps), 20):.4f} ms, plain "
        f"{cuda_ms(lambda: raster_cuda.rasterize_interp_reference(*args, **caps), 5):.4f} ms")

    # ---- scene + pipelines -------------------------------------------------
    t0 = time.perf_counter()
    scene, cfg, base_knobs, knobs, pipe, cam = textured_cell(dev)
    planar = DeferredRenderPipeline(scene, cfg, use_tex_kernel=False, device=dev, **knobs)
    torch.cuda.synchronize()
    if not (pipe.use_pallas and pipe.use_tex_kernel and pipe.use_fused_deferred):
        fail("scene", "the default pipeline on the card is not the fused kernel path")
    say("scene", f"stress scene {pipe.packed.tris.shape[0]} tris, "
        f"{pipe.packed.light_count} lights, albedo map {tuple(pipe.packed.atlas.base_size[0])}"
        f", sky 256, precompute + pack of two pipelines "
        f"{time.perf_counter() - t0:.2f} s; default path: use_pallas={pipe.use_pallas} "
        f"use_tex_kernel={pipe.use_tex_kernel} tex_caps={TEX_CAPS} brdf_lut_size={BRDF_LUT}; "
        f"planar path: use_pallas="
        f"{planar.use_pallas} use_tex_kernel={planar.use_tex_kernel}")

    # ---- kernel A vs plain version at the main path's shapes ---------------
    setup, bins, rows64, stage_ms = frame_inputs(pipe, cam)
    args = (setup, bins, rows64, pipe.render_w, pipe.render_h, TILE_H, TILE_W)
    err_a, nmis = compare("kernel-frame", raster_cuda.rasterize_interp(*args),
                          raster_cuda.rasterize_interp_reference(*args))
    ms_a = cuda_ms(lambda: raster_cuda.rasterize_interp(*args), 20)
    plain_ms_a = cuda_ms(lambda: raster_cuda.rasterize_interp_reference(*args), 3)

    def alone(**caps):  # the kernel's own device time, and all the call's device work
        return device_ms(lambda: raster_cuda.rasterize_interp(*args, **caps), 10,
                         "raster_interp")

    # the kernel alone with every bin list cut to one chunk: what is left is
    # the output and the first chunk, so the difference is the longer lists
    (alone_ms_a, busy_ms_a), (one_chunk_ms, _) = alone(), alone(cap_small=raster_cuda.CHUNK,
                                                                  hot_k=0)
    counts = bins.counts.cpu().numpy()
    census = fold_census(setup, bins, pipe.render_w, pipe.render_h, TILE_H, TILE_W)
    # output 26 words per pixel, the fold's reads and the 40 payload words of
    # each distinct winner; 23 flops (3 edge scores, the barycentric
    # denominator and depth, one division) per (pixel, candidate) pair whose
    # pixel lies inside the candidate's AABB, and 45 per pixel for the
    # winner's 8 interpolated channels
    n_px = pipe.render_w * pipe.render_h
    ids_a = raster_cuda.rasterize_interp(*args)[0]
    winners = int(torch.unique(ids_a[ids_a >= 0]).numel())
    del ids_a
    bounds = {"raster_interp": bound(
        n_px * 26 * 4 + fold_read_bytes(census, bins) + winners * 40 * 4,
        census["inside"] * 23 + n_px * 45)}
    say("kernel-frame", f"{W}x{H} {rows64.shape[0]} tris, bin counts p50 "
        f"{np.percentile(counts, 50):.0f} p99 {np.percentile(counts, 99):.0f} max "
        f"{counts.max()}: ids, z and planes bit-equal to the plain version (id mismatches "
        f"{nmis}, max_abs_err {err_a:.3e}); kernel through its wrapper {ms_a:.4f} ms (CUDA "
        f"events; device busy {busy_ms_a:.4f} ms of it, torch.profiler), the kernel alone "
        f"{alone_ms_a:.4f} ms (torch.profiler), plain "
        f"{plain_ms_a:.4f} ms, bound {bounds['raster_interp'][0]:.4f} ms "
        f"({bounds['raster_interp'][1]}; {winners} distinct winners) on {smi}; the kernel "
        f"alone with every list cut to {raster_cuda.CHUNK} entries {one_chunk_ms:.4f} ms (full "
        f"lists {alone_ms_a / one_chunk_ms:.2f}x); {census_line(census)}")
    measured = {"raster_interp": (err_a, ms_a, plain_ms_a, alone_ms_a)}
    n_h = raster_depth_stage("kernel-raster-depth", setup, bins, rows64, pipe.render_w,
                             pipe.render_h, census, smi, measured, bounds)

    # ---- kernels B, C, D vs plain versions on one default frame's inputs ---
    with contextlib.ExitStack() as stack:
        cover_calls = stack.enter_context(recording(cover_cuda, "fused_cover"))
        shade_calls = stack.enter_context(recording(resolve_shade_cuda, "resolve_shade"))
        deferred_calls = stack.enter_context(recording(shade_fused, "deferred_kernel"))
        pipe.render(cam, collect_stats=False)
        torch.cuda.synchronize()
    if (len(cover_calls), len(shade_calls), len(deferred_calls)) != (4, 1, 1):
        fail("kernel-cover", f"a default frame made {len(cover_calls)} cover, "
             f"{len(shade_calls)} resolve-shade and {len(deferred_calls)} deferred calls, "
             "want 4, 1, 1")
    parts, cover_ms, cover_alone_ms, cover_plain_ms = [], [], [], []
    cover_bytes = plane_bytes = 0
    for (cargs, ckw), what in zip(cover_calls, ("texture fallback", "texture lo half",
                                                "texture hi half", "env")):
        got = cover_cuda.fused_cover(*cargs, **ckw)
        want = cover_cuda.fused_cover_reference(*cargs, **ckw)
        for g, r, out in zip(got, want, ("list", "count", "slot", "covered")):
            if not torch.equal(g, r):
                fail("kernel-cover", f"{what}: {out} differs from the plain version")
        tiles, g_, blocks, _ = cargs[0].shape
        live, empty = cover_census(cargs[0], cargs[1], cargs[3])
        call_bytes = cover_bytes_needed(cargs, got, empty)
        cover_bytes += call_bytes
        plane_bytes += nbytes(cargs[0], cargs[1], *got)
        k_ms = cuda_ms(lambda: cover_cuda.fused_cover(*cargs, **ckw), 20)
        p_ms = cuda_ms(lambda: cover_cuda.fused_cover_reference(*cargs, **ckw), 5)
        alone = graph_ms(lambda: cover_cuda.fused_cover(*cargs, **ckw), 20)
        cover_ms.append(k_ms)
        cover_alone_ms.append(alone)
        cover_plain_ms.append(p_ms)
        parts.append(f"{what} ({tiles}x{g_}x{blocks}x128, caps {max(cargs[2])}, block_cap "
                     f"{cargs[3]}; {float(cargs[1].float().mean()):.3f} active; live "
                     f"candidates per item p50 {float(live.float().median()):.0f} max "
                     f"{int(live.max())}, empty items {float(empty.float().mean()):.3f}) kernel "
                     f"{k_ms:.4f} ms (the kernel alone {alone:.4f}), "
                     f"plain {p_ms:.4f} ms, bound {bound(call_bytes)[0]:.4f} ms "
                     f"({call_bytes / 1e6:.1f} MB)")
    ms_b, plain_ms_b = sum(cover_ms), sum(cover_plain_ms)
    bounds["fused_cover"] = bound(cover_bytes)
    EARLIER_BOUNDS["fused_cover"] = bound(plane_bytes)[0]
    say("kernel-cover", "4 calls of one default 1080p frame, all four outputs bit-equal: "
        + "; ".join(parts) + f"; per frame kernel {ms_b:.4f} ms through its wrapper (CUDA "
        f"events), the kernel alone {sum(cover_alone_ms):.4f} ms (CUDA graph replays), plain "
        f"{plain_ms_b:.4f} ms, "
        f"bound {bounds['fused_cover'][0]:.4f} ms (bytes: act, outputs and the pages of "
        f"non-empty items, {cover_bytes / 1e6:.1f} MB; {bound(plane_bytes)[0]:.4f} ms over "
        f"every item's pages, {plane_bytes / 1e6:.1f} MB)")

    (sargs, skw), = shade_calls

    def shade():
        return resolve_shade_cuda.resolve_shade(*sargs, **skw)

    err_c = check_shade("kernel-resolve-shade", shade(),
                        resolve_shade_cuda.resolve_shade_reference(*sargs, **skw))
    ms_c = cuda_ms(shade, 20)
    cold_c = cold_ms(shade, 20)
    host_c = host_ms(shade, 20)
    alone_c, busy_c = device_ms(shade, 10, "resolve_shade")
    plain_ms_c = cuda_ms(lambda: resolve_shade_cuda.resolve_shade_reference(*sargs, **skw), 3)
    # off and cnts, the planes' words that the output reads, of the staged
    # pages the words its taps address, and the (tiles, 9, blocks, 128) f32
    # output; a few dozen flops per pixel, far below the bytes' time. The
    # earlier bound read every word of every input.
    rec_c = sargs[3]
    out_c = rec_c.shape[0] * 9 * rec_c.shape[2] * 128 * 4
    reads_c = resolve_shade_reads(sargs, skw)
    bounds["resolve_shade"] = bound(
        nbytes(*sargs[:2]) + sum(int(m.sum()) * 4 for m in reads_c.values())
        + staged_read_bytes(*sargs[:4], 4, reads_c["rec"]) + out_c)
    EARLIER_BOUNDS["resolve_shade"] = bound(
        nbytes(*sargs[:2], *sargs[3:]) + staged_read_bytes(*sargs[:4], 4) + out_c)[0]
    ops_c = only_kernel("kernel-resolve-shade", shade, "resolve_shade")
    say("kernel-resolve-shade", f"{tuple(sargs[3].shape)} taps, staged "
        f"{tuple(sargs[2].shape)}: ok (max diff {err_c:.3e} <= {SHADE_MAX:.3e}), kernel "
        f"{ms_c:.4f} ms through its wrapper (CUDA events; {cold_c:.4f} ms with the L2 evicted "
        f"before each call; host time {host_c:.4f} ms a call), the kernel alone {alone_c:.4f} ms, the rest of the call's device "
        f"work (layout copies) {busy_c - alone_c:.4f} ms (torch.profiler), plain "
        f"{plain_ms_c:.4f} ms, bound {bounds['resolve_shade'][0]:.4f} ms "
        f"({bounds['resolve_shade'][1]}: the words the output reads; over every word of every "
        f"input {EARLIER_BOUNDS['resolve_shade']:.4f} ms); taps the output reads "
        f"{int(reads_c['rec'].sum())} of {rec_c.numel()}; one call dispatches {ops_c} and "
        f"traces only its kernel; planes' strides {plane_layouts(sargs[3:])}")

    (dargs, dkw), = deferred_calls

    def deferred():
        return shade_fused.deferred_kernel(*dargs, **dkw)

    err_d, bad_d = check_deferred("kernel-deferred", deferred(),
                                  shade_fused.deferred_kernel_reference(*dargs, **dkw))
    ms_d = cuda_ms(deferred, 20)
    cold_d = cold_ms(deferred, 20)
    host_d = host_ms(deferred, 20)
    alone_d, busy_d = device_ms(deferred, 10, "deferred_shade")
    plain_ms_d = cuda_ms(lambda: shade_fused.deferred_kernel_reference(*dargs, **dkw), 3)
    # const, lights, off and cnts, the planes' words that the output reads,
    # of the staged pages the words its taps address, and the (tiles, 4,
    # blocks, 128) output; about 60 flops per pixel and active light. The
    # earlier bound read every word of every input.
    rec_d = dargs[5]
    px_d = rec_d.shape[0] * rec_d.shape[2] * 128
    reads_d = deferred_reads(dargs, dkw)
    bounds["deferred_shade"] = bound(
        nbytes(*dargs[:4]) + sum(int(m.sum()) * 4 for m in reads_d.values())
        + staged_read_bytes(*dargs[2:6], 8, reads_d["rec"]) + px_d * 4 * 4,
        px_d * float(dargs[0][21]) * 60)
    EARLIER_BOUNDS["deferred_shade"] = bound(
        nbytes(*dargs[:4], *dargs[5:]) + staged_read_bytes(*dargs[2:6], 8) + px_d * 4 * 4,
        px_d * float(dargs[0][21]) * 60)[0]
    lit_d = dargs[8][:, 10] > 0.5
    taps_lit = float(reads_d["rec"].sum(1)[lit_d].float().mean())
    ops_d = only_kernel("kernel-deferred", deferred, "deferred_shade")
    say("kernel-deferred", f"{tuple(dargs[5].shape)} env taps, {int(dargs[0][21])} active "
        f"lights: ok ({bad_d:.2e} of pixels outside rtol {D_RTOL}/atol {D_ATOL}, max abs "
        f"diff {err_d:.3e}), kernel {ms_d:.4f} ms through its wrapper (CUDA events; "
        f"{cold_d:.4f} ms with the L2 evicted before each call; host time {host_d:.4f} ms a "
        f"call), the kernel alone "
        f"{alone_d:.4f} ms, the rest of the call's device work (layout copies) "
        f"{busy_d - alone_d:.4f} ms (torch.profiler), plain {plain_ms_d:.4f} ms, bound "
        f"{bounds['deferred_shade'][0]:.4f} ms ({bounds['deferred_shade'][1]}: the words the "
        f"output reads; over every word of every input {EARLIER_BOUNDS['deferred_shade']:.4f} "
        f"ms); env taps the output reads: {taps_lit:.3f} per lit pixel (the kernel gathers "
        f"{rec_d.shape[1] - 1}), 1 per background pixel; one call dispatches {ops_d} and "
        f"traces only its kernel; planes' strides {plane_layouts(dargs[5:])}; "
        f"{deferred_census(dargs, dkw)}")
    del shade_calls, deferred_calls, sargs, dargs

    # ---- GBuffer pass stages of both paths ---------------------------------
    tri_id, depth, planes = raster_cuda.rasterize_interp(*args)
    stage_ms["gbuffer_shade_planar"] = cuda_ms(lambda: gbuffer.gbuffer_shade_planar(
        tri_id, depth, planes, planar.buffers["atlas"]), 3)
    say("stages-planar", "GBuffer pass stages of the use_tex_kernel=False path, mean device "
        "ms (CUDA events): " + ", ".join(
            f"{k} {v:.2f}" for k, v in {**stage_ms, "rasterize_interp": ms_a}.items()))
    tiled = raster_cuda.rasterize_interp(*args, return_tiled=True)
    fused_ms = {
        **{k: stage_ms[k] for k in ("geometry", "binning", "pack_rows64")},
        "rasterize_interp (tiled)": cuda_ms(
            lambda: raster_cuda.rasterize_interp(*args, return_tiled=True), 5),
        "gbuffer_shade_fused": cuda_ms(lambda: gbuffer.gbuffer_shade_fused(
            tiled[0], tiled[1], tiled[2], tiled[3], pipe.buffers["atlas"], pipe.render_h,
            pipe.render_w, TILE_H, TILE_W, tex_caps=TEX_CAPS, return_tiled=True), 3),
    }
    say("stages", "GBuffer pass stages of the default path, mean device ms (CUDA events): "
        + ", ".join(f"{k} {v:.2f}" for k, v in fused_ms.items())
        + f"; of gbuffer_shade_fused, kernel B (3 texture covers) {sum(cover_ms[:3]):.2f}, "
        f"kernel C {ms_c:.2f}")
    del tiled, tri_id, depth, planes

    # ---- the main path: the default frame through kernels A, B, C, D --------
    path = camera_path(cam, WARMUP + FRAMES)
    for c in path[:WARMUP]:
        pipe.render(c)
    times, launches = run_frames("frame", pipe, path[WARMUP:], {
        "raster_interp": FRAMES, "fused_cover": 4 * FRAMES, "resolve_shade": FRAMES,
        "deferred_shade": FRAMES})
    frame_line = check_frame("frame", pipe, path[-1])
    say("frame", f"default path, {FRAMES} frames {W}x{H}: mean {np.mean(times):.2f} ms, p50 "
        f"{np.median(times):.2f} ms (host clock, synchronized per frame); kernel launches "
        f"{launches}; {frame_line}")
    per_pass = timed_passes(pipe, path[-1], 3)
    say("passes", "default path, mean device ms per pass (CUDA events): " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_pass.items()))
    wall, busy, n_act, top = profiled_frames(pipe, path[-1], 3)
    if busy <= 0:
        fail("profile", "torch.profiler recorded no device time")
    say("profile", f"default path, torch.profiler, 3 frames: wall {wall:.2f} ms/frame, device "
        f"busy {busy:.2f} ms/frame ({n_act:.0f} device activities), idle share "
        f"{1 - busy / wall:.3f}; top: " + "; ".join(f"{ms:.2f} ms {name[:60]}"
                                                    for ms, name in top))

    # ---- the use_tex_kernel=False path through kernel A ---------------------
    ppath = camera_path(cam, 1 + PLANAR_FRAMES)
    planar.render(ppath[0])
    ptimes, plaunches = run_frames("frame-planar", planar, ppath[1:],
                                   {"raster_interp": PLANAR_FRAMES})
    frame_line = check_frame("frame-planar", planar, ppath[-1])
    say("frame-planar", f"use_tex_kernel=False path, {PLANAR_FRAMES} frames: mean "
        f"{np.mean(ptimes):.2f} ms, p50 {np.median(ptimes):.2f} ms; kernel launches "
        f"{plaunches}; {frame_line}")
    per_pass = timed_passes(planar, ppath[-1], 2)
    say("passes-planar", "use_tex_kernel=False path, mean device ms per pass (CUDA events): "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_pass.items()))
    wall, busy, n_act, top = profiled_frames(planar, ppath[-1], 2)
    say("profile-planar", f"use_tex_kernel=False path, torch.profiler, 2 frames: wall "
        f"{wall:.2f} ms/frame, device busy {busy:.2f} ms/frame ({n_act:.0f} device "
        f"activities), idle share {1 - busy / wall:.3f}; top: " + "; ".join(
            f"{ms:.2f} ms {name[:60]}" for ms, name in top))

    # ---- both frames against the all-plain pipeline on the card ------------
    ref = DeferredRenderPipeline(scene, cfg, use_pallas=False, use_tex_kernel=False,
                                 device=dev, **knobs)
    rmse, ndiff = fidelity(pipe, ref, path[-1])
    stats = pipe.last_stats
    if rmse > RMSE_BAR:
        fail("fidelity", f"default frame rmse vs use_pallas=False, use_tex_kernel=False "
             f"{rmse:.6f} > {RMSE_BAR}; tex_approx_taps {stats.tex_approx_taps}, "
             f"env_approx_taps {stats.env_approx_taps}")
    # the same frame with the JAX package's default knobs, for the record
    # (not gated: its caches overflow on this cell)
    jax_knobs = DeferredRenderPipeline(scene, cfg, device=dev, **base_knobs)
    jax_knobs.avg_luminance = pipe.avg_luminance.clone()
    rmse_j, _ = fidelity(jax_knobs, DeferredRenderPipeline(
        scene, cfg, use_pallas=False, use_tex_kernel=False, device=dev, **base_knobs), path[-1])
    stats_j = jax_knobs.last_stats
    del jax_knobs
    say("fidelity", f"default frame (tex_caps {TEX_CAPS}, brdf_lut_size {BRDF_LUT}) rmse vs "
        f"use_pallas=False, use_tex_kernel=False on the card {rmse:.6f} <= {RMSE_BAR}; "
        f"{ndiff} pixels differ; tex_approx_taps {stats.tex_approx_taps}, env_approx_taps "
        f"{stats.env_approx_taps}; with the JAX default knobs (not gated): rmse "
        f"{rmse_j:.6f}, tex_approx_taps {stats_j.tex_approx_taps}, env_approx_taps "
        f"{stats_j.env_approx_taps}")
    rmse, ndiff = fidelity(planar, ref, ppath[-1])
    if rmse > RMSE_BAR:
        fail("fidelity-planar", f"frame rmse vs use_pallas=False {rmse:.6f} > {RMSE_BAR}")
    say("fidelity-planar", f"use_tex_kernel=False frame rmse vs use_pallas=False on the card "
        f"{rmse:.6f} <= {RMSE_BAR}; {ndiff} pixels differ")
    del planar, ref
    torch.cuda.empty_cache()
    measured.update({"fused_cover": (0.0, ms_b, plain_ms_b, sum(cover_alone_ms)),
                     "resolve_shade": (err_c, ms_c, plain_ms_c, alone_c, cold_c),
                     "deferred_shade": (err_d, ms_d, plain_ms_d, alone_d, cold_d)})

    # ---- the planar texture-cache, cap-156 and anisotropic paths ------------
    launches_ptex = planar_tex_cells(dev, scene, cfg, cam, knobs, pipe, cover_calls,
                                     measured, bounds)
    del pipe, scene, cover_calls, setup, bins, rows64, args
    torch.cuda.empty_cache()

    launches_l1k = lights1k(dev, cam, knobs, base_knobs, measured, bounds)
    launches.update({k: launches_l1k[k] for k in ("env_resolve", "point_lights")})
    torch.cuda.empty_cache()
    n_h_assets = asset_auto(dev, cam, smi)
    # H's launches: the depth-only stage call and the asset-auto census's
    launches.update(launches_ptex, raster_depth=n_h + n_h_assets)
    say("profiler", f"kernel traces: {TRACES['complete']} complete, "
        f"{len(TRACES['partial'])} partial ones traced again (kernel held/launched): "
        f"{TRACES['partial']}")
    torch.cuda.empty_cache()
    bench_phase()
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"direct12pbrrenderer_tpu_torch/csrc/{source_of(name)}.cu",
        "replaces": KERNELS[name][0], "launches": launches[name],
        "max_abs_err": measured[name][0], "ms": measured[name][1],
        "plain_ms": measured[name][2], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": None,
        # the kernel's own device time beside "ms", the wrapper's: A, C, D,
        # E, F, H and I by torch.profiler, B and G by CUDA graph replays of
        # the wrapper's call; both warm-L2 times (the runs repeat on the same
        # inputs). C, D, E, F, I also through the wrapper with the L2 evicted
        # before each call; B, C, D, G also their earlier, looser bounds.
        "kernel_ms": (measured[name] + (None,))[3],
        "cold_ms": (measured[name] + (None, None))[4],
        "earlier_bound_ms": EARLIER_BOUNDS.get(name)} for name in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
