"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `direct12pbrrenderer_tpu_torch/csrc` (one
nvcc per source, all at once), checks each against its plain PyTorch version
on the card, then renders at 1920x1080 with a procedural sky:

* the 262,144-triangle stress scene through the default path (`use_pallas`
  and `use_tex_kernel` resolve to True on the card): kernel A (raster +
  interpolation), kernel B (page covers of the texture and env caches),
  kernel C (texture resolve + pixel shade), kernel D (fused deferred
  shading) — the main path, first run eagerly inside `deferred.eager()`
  ([frame], [passes], [profile]), then as a user's `render` runs it on the
  card, one captured CUDA graph a frame ([frame-graph]: the capture's
  seconds and memory pool, captured frames bit-equal to eager ones, timed
  and traced, no host sync under the sync debug mode, `render_sequence`
  bit-equal to a loop of `render` calls and timed against it). Every other
  path below renders as one captured CUDA graph a frame too ([frame-*]
  time replays; [passes-*] run eagerly); [frame-graph-paths] captures each
  anew (seconds, pool bytes), holds PATH_FRAMES captured frames to eager
  ones bit for bit with each replay's launches equal to its eager frame's,
  times both, checks for host syncs under the sync debug mode and traces
  the replays: `use_tex_kernel=False`, all-plain, planar-tex and
  anisotropic on this scene, the 1024-light path and its all-plain
  reference on the 1024-light scene;
* the JAX package's reference-only functions, ported as plain PyTorch
  ([reference-fns]): the literal bloom chain against the pipeline's bloom
  on the default frame's pre-bloom image (both timed), the per-cluster
  light lists of the 1024-light cell (timed) and their parameter rows, the
  cluster index, barycentrics and 2D bilinear sampler on the default
  frame's planes, and the env prefilter from the sky's cube-map texture,
  each held to the same call on the CPU;
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
* the default path with `fused_light_dtype="bfloat16"` ([frame-bf16]): kernel
  D's bfloat16 light loop, its frame against the float32 and the all-plain
  frames (rmse printed, not gated), its FrameStats equal to the float32
  frame's;
* the 1024-light stress scene (the JAX bench's third scene) through the
  1024-light path: kernels A, B, C for the G-buffer, then the unfused
  deferred pass with the env cache (plan with kernel B, resolve with kernel
  F) and the tile-clustered point lights (kernel G);
* the same scene at `max_active_lights=64` ([kernel-deferred-dtypes]): the
  fused deferred pass with kernel D's float32, bfloat16 and float16 light
  loops (`fused_light_dtype`) at D's most, 64 active lights, each instance
  launched on its path, held to its plain version bit for bit and timed;
* the band frame (`parallel/frame_sharded.py`): the textured cell on four
  gloo ranks sharing the card in 270-row bands on 288-row canvases
  ([sharded]), on one NCCL rank ([sharded-nccl]), and the 1024-light cell on
  two gloo ranks in 540-row bands on 552-row canvases ([sharded-lights1k]);
  each rank holds one eager band frame's kernel calls to their plain
  versions, captures the band frame (one CUDA graph a frame on NCCL ranks;
  the band body on gloo ranks, whose post chain stays eager), holds
  captured frames to eager ones bit for bit, counts the replays' launches
  (A, B four times, C, D; or A, B four times, C, F, G), times captured
  against eager frames, and traces 3 captured frames (idle share, NCCL
  time); rank 0 holds the gathered frame to the single-card `render()` of
  the pose and carry (bit for bit on one rank);
* the textured cell's content as an asset tree ([asset-auto]): written as
  OBJ/MTL/PNG and HDR faces, imported by the port's importers (BC1, BC6H),
  reloaded through a fresh ResourceLoader and rendered with
  `tex_caps="auto"`: the first frame's tap census runs the depth-only
  kernel H (held to the census with the plain fold), then the sized frames
  run kernels A-D at the census-sized caps, the cascade and the compact
  staging budgets;
* the App ([app-tree], [app], [viewer], [profile-app], [census-main]): a
  tree T built with the port's console, one process a command (a 256^2
  procedural sky, the sphere, the stress terrain at 128x64 cells imported
  from OBJ/MTL/PNG), and a Scene JSON at the App's default path (the
  terrain, 32 spheres on an 8x4 grid, 8 lights, the sky); the App's command
  line renders 60 frames at the AppConfig defaults (1440x960 on a 1536-wide
  canvas, texture caps (92, 44, None, (24, 12)), the cascade (12, 8, 0),
  raster caps (128, 64)) to PNGs; the same App in process launches A once,
  B five times, C and D once a frame, its calls held to their plain
  versions, its first frame bit-equal to a directly built pipeline's, its
  frame held to the same pipeline with its kernels' plain versions (the
  gate) and compared with the all-plain pipeline (`app_fidelity`: on T the
  AppConfig knobs' counted losses, the raster's hot-set miss and the env
  LUT group's fallbacks, fail that bar, as they do in the JAX package; the
  line says so); the viewer in a fresh process, whose first frame
  and first kernel use come on an HTTP handler thread; tools/profile's
  stages on the App's pipeline; tools/tap_census.main over 8 poses (16
  launches of H); tools/checklist in a process of its own at 1440x960
  (baseline, staging and env budgets, the `rpc` split of `render`);
* last, the port's bench (`direct12pbrrenderer_tpu_torch.bench`) as a user
  runs it, `--smoke`, then the full run at its default 32 frames: the smoke
  sphere (kernels A, B, E, F), the Sponza-class headline (A-D) and the
  1024-light cell (A, B, C, F, G) at the JAX bench's knobs, each gate
  binding ([bench] lines). The reference-scene cell (`--asset-root`, the
  App at the AppConfig defaults) is not run here: on tree T its gate fails
  for the knobs' counted losses and the cell falls back (ROADMAP.md
  section 3).

`python3 chip_smoke.py --cards` runs only the band frame of the textured
cell, on one NCCL rank and then on one NCCL rank a card on every card of
the machine (`[sharded-cards]`), for the band frame's time on several cards.

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
import dataclasses
import gc
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent   # the checkout: the port's package and build/
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
# [frame-graph]: captured frames timed, held to eager ones, under the sync
# debug mode, and the render_sequence length
GRAPH_FRAMES, EQUAL_FRAMES, SYNC_FRAMES, SEQ_FRAMES = 16, 4, 8, 32
# [frame-graph-paths]: frames held captured against eager on each path, the
# render_sequence length under the sync debug mode, and the launches a frame
# of each path's kernels makes (the all-plain path launches none)
PATH_FRAMES, PATH_SEQ = 3, 8
PATH_KERNELS = {
    "lights1k": {"raster_interp": 1, "fused_cover": 4, "resolve_shade": 1, "env_resolve": 1,
                 "point_lights": 1},
    "planar-tex": {"raster_interp": 1, "fused_cover": 4, "atlas_resolve": 1, "env_resolve": 1},
    "anisotropic": {"raster_interp": 1, "fused_cover": 1, "env_resolve": 1},
    "use_tex_kernel=False": {"raster_interp": 1},
    "all-plain": {},
}
PLANAR_FRAMES = 4         # the use_tex_kernel=False path
PTEX_FRAMES, ANISO_FRAMES = 8, 2   # the planar texture-cache and anisotropic paths
BF16_FRAMES = 8           # the default path with fused_light_dtype="bfloat16"
DTYPE_FRAMES, DTYPE_LIGHTS = 4, 64   # [kernel-deferred-dtypes]: frames a light_dtype,
                                     # active lights (kernel D's most)
# kernel D's light body (csrc/deferred_shade.cu light_body): 96 sums,
# products and maxima in the loop's type and 10 float32 operations (2 square
# roots, 5 reciprocals, 3 accumulations) for each (lit pixel, light) hit;
# 18 float32 operations of the cluster-sphere test and the hit counter for
# every (pixel, light) pair
D_BODY_OPS, D_BODY_F32_OPS, D_SPHERE_OPS = 96, 10, 18
PTEX_TILE = (24, 160)     # the planar-tex cell's raster tile: not 128 wide
CAP156 = (156, 44, None, (32, 16))  # a lo-half cap above 128: kernel I
RMSE_BAR = 1e-3          # uint8/255 frame rmse, the JAX package's fidelity bar
SHADE_MAX, SHADE_FRAC = 1.01 / 255.0, 2e-3   # kernel C: 1 LSB, on < 0.2% of values
G_RTOL, G_ATOL, G_COUNTER_FRAC = 1e-4, 1e-5, 1e-4  # kernel G: a log/pow ulp at a
                                                   # cluster edge flips a membership
F_RTOL, F_ATOL = 1e-6, 1e-7   # kernels F and E: the same staged words and weights
# [reference-fns]: the JAX package's reference-only functions on the card.
# bloom vs bloom_reference: rtol and atol 2e-5, the JAX package's own bar
# (tests/test_postprocess.py); its two blooms differ by 1.14e-5 at most at
# 1920x1080 on the CPU (PERF.md). The cull's (cluster, light) decisions and
# the cluster indices may differ from the CPU's on max(1, 1e-4) of them (a
# one-ulp change at a cluster face or slice edge); the barycentrics within
# rtol 1e-5 of the CPU, atol 1e-6 for weights that cancel to near 0 at a
# triangle's edge; the bilinear sampler within rtol 1e-6; the env prefilter,
# 1024 samples summed in the same order, within rtol 1e-4 / atol 2e-5,
# held at REF_PF_SIZE (the CPU run at the pipeline's 256 takes minutes)
REF_BLOOM_BAR, REF_DECISION_FRAC = 2e-5, 1e-4
REF_BARY_RTOL, REF_BARY_ATOL, REF_SAMPLER_RTOL = 1e-5, 1e-6, 1e-6
REF_PF_RTOL, REF_PF_ATOL, REF_PF_SIZE = 1e-4, 2e-5, 64
# the asset-auto cell: the textured stress cell's terrain (512x256 cells,
# 262,144 triangles) imported from source files, with tex_caps="auto"
ASSET_CELLS = (512, 256)
# the [app] cell: a tree built with the port's console (tools/stress_scene's
# terrain at APP_CELLS imported from OBJ/MTL/PNG, the console's sphere on an
# APP_GRID of instances, the terrain's 8 lights, a 256^2 sky: 33 models,
# 63,488 triangles, within the App's 65,536-triangle pool; 73,504 vertices,
# for which pack_scene grows the App's 65,536-vertex pool), rendered by the App at
# the AppConfig defaults from APP_POSE ((x, y, z), yaw, pitch in degrees,
# orbit degrees per frame: the stress cells' pose); each frame launches
# kernel A once, B five times (texture fallback, lo, hi, the cascade, env),
# C and D once, and no other
APP_CELLS, APP_GRID = (128, 64), (8, 4)
APP_POSE = ((0.0, 6.0, 18.0), 180.0, 20.05, 1.0)
APP_KERNELS = {"raster_interp": 1, "fused_cover": 5, "resolve_shade": 1, "deferred_shade": 1}
APP_COUNTED = 8          # frames whose launches [app] counts
# the 1024-light cell: the JAX bench's third scene (bench.py _lights1k_bench)
L1K_CELLS, L1K_LIGHTS, L1K_BIN_CAP = (128, 64), 1024, 2048
BASE_KNOBS = dict(tile_h=TILE_H, tile_w=TILE_W, bin_cap=BIN_CAP, atlas_max_dim=256)
# the band phases (parallel/frame_sharded.py): phase -> (cell, ranks, device
# of the ranks, the kernels of the band path with their launches a band
# frame, the kernels it must not launch). Four gloo ranks share card 0 in
# 270-row bands on 288-row canvases; one NCCL rank renders the whole frame
# as one band; two gloo ranks render the 1024-light cell in 540-row bands
# on 552-row canvases (kernels F and G at y_offset 540).
BAND_A_D = {"raster_interp": 1, "fused_cover": 4, "resolve_shade": 1, "deferred_shade": 1}
BAND_L1K = {"raster_interp": 1, "fused_cover": 4, "resolve_shade": 1, "env_resolve": 1,
            "point_lights": 1}
BAND_PHASES = {
    "sharded": ("textured", 4, "cuda:0", BAND_A_D, ("env_resolve", "point_lights")),
    "sharded-nccl": ("textured", 1, "cuda", BAND_A_D, ("env_resolve", "point_lights")),
    "sharded-lights1k": ("lights1k", 2, "cuda:0", BAND_L1K, ("deferred_shade",)),
    # `--cards` only: one NCCL rank on each card of the machine (0: every card)
    "sharded-cards": ("textured", 0, "cuda", BAND_A_D, ("env_resolve", "point_lights")),
}
BAND_FRAMES = 4   # band frames timed a rank; the launch counts are read after them
BAND_EQUAL = 2    # captured band frames held bit for bit to eager ones
# NVIDIA H100 SXM data sheet: HBM3 bytes/s and float32 (non-tensor) FLOP/s;
# the Hopper architecture whitepaper: float16 and bfloat16 (non-tensor) FLOP/s
HBM_BYTES_PER_S, F32_FLOP_PER_S, F16_FLOP_PER_S = 3.35e12, 67e12, 133.8e12
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
    # kernel D's light_dtype instances (the pipeline's fused_light_dtype): its
    # launches with that light loop, counted apart (and in D's count too)
    **{f"deferred_shade_{ld}": (f"direct12pbrrenderer_tpu/ops/shade_pallas.py:61 "
                                f"(light_dtype={ld!r}, :218-312)", "shade_fused",
                                "deferred_kernel", f"{ld}_launches")
       for ld in ("float32", "bfloat16", "float16")},
}
WIDE = "cover_wide"
D_DTYPES = {f"deferred_shade_{ld}": ld for ld in ("float32", "bfloat16", "float16")}
# counters of a kernel's launches at one instance of it: a path launches
# them only where it asks for them
INSTANCES = (WIDE, *D_DTYPES)
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
# kernel I runs kernel B's source and device kernel, D's instances D's
SOURCES = {WIDE: "fused_cover", **{name: "deferred_shade" for name in D_DTYPES}}


def source_of(name: str) -> str:
    """The csrc/ source (without .cu) that builds kernel `name`; its device
    kernel is `<source>_kernel`."""
    return SOURCES.get(name, name)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    say(phase, "FAIL " + msg)
    print(f"[{phase}] FAIL {msg}", file=sys.stderr, flush=True)   # where only stderr is kept
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
# idle host time on each side of a traced run, inside the profiler's active
# window: on an H100 torch.profiler drops device activities that lie near
# the window's edges (PyTorch's own kernels as well as the port's), and with
# a few ms of pad it has dropped none
TRACE_PAD_S = 0.02
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
    work, traced and dropped, comes first (the profiler's own schedule), and
    the traced run sits TRACE_PAD_S of idle time away from both edges of the
    active window: on an H100 launches near either edge have gone missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_PAD_S)
        n0 = read_launches()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_PAD_S)
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


def compare(phase, got, want, empty_ok: bool = False) -> tuple[float, int]:
    """Hold a raster's outputs (tri_id, z[, planes]) against another's bit for
    bit: kernels A and H and their plain versions evaluate the same float32
    formulas with every product and sum rounded on its own and one tie rule.
    Returns (max abs error of z and planes where the ids agree, id
    mismatches), both 0 when it passes. Fails on a canvas where the plain
    version covers no pixel, unless `empty_ok` (a band of the frame may
    hold only sky)."""
    ids_k, ids_p = got[0], want[0]
    agree = ids_k == ids_p
    if not empty_ok and not (agree & (ids_p >= 0)).any():
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


def deferred_bytes(dargs, dkw) -> tuple[int, int]:
    """Bytes kernel D's call must move: const, lights, off and cnts, the
    planes' words that the output reads (`deferred_reads`), of the staged
    pages the words its taps address, and the (tiles, 4, blocks, 128)
    output; and the same over every word of every input."""
    rec = dargs[5]
    out = rec.shape[0] * 4 * rec.shape[2] * 128 * 4
    reads = deferred_reads(dargs, dkw)
    return (nbytes(*dargs[:4]) + sum(int(m.sum()) * 4 for m in reads.values())
            + staged_read_bytes(*dargs[2:6], 8, reads["rec"]) + out,
            nbytes(*dargs[:4], *dargs[5:]) + staged_read_bytes(*dargs[2:6], 8) + out)


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
    the recorder, not on the wrapper. Frames rendered meanwhile run eagerly
    (`deferred.eager()`: a captured frame's replay calls no wrapper; a tree
    older than the captured frame, which kernel_ab.py may import, has none)."""
    from direct12pbrrenderer_tpu_torch.pipeline import deferred

    eager = getattr(deferred, "eager", contextlib.nullcontext)
    orig = getattr(module, name)
    calls = []

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    for *_, fn, counter in KERNELS.values():
        if fn == name:
            setattr(rec, counter, 0)
    setattr(module, name, rec)
    try:
        with eager():
            yield calls
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def counting(module, name: str, launches: dict):
    """While the block runs, each call of `module.name` runs with every launch
    count set to 0 just before it; the counts read just after go to
    `launches[name]` (a captured frame's replay adds its kernels' launches
    too)."""
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


def hold_call(phase: str, name: str, args, kw, empty_ok: bool = False) -> float:
    """Hold one recorded call of kernel `name`'s wrapper against its plain
    version on the same inputs, at the bar the kernels line holds it to;
    returns the max abs error. `empty_ok`: as in `compare`."""
    fn, _ = wrapper(name)
    ref = getattr(sys.modules[fn.__module__], f"{KERNELS[name][2]}_reference")
    if name == "raster_interp":   # the plain version gives the untiled outputs
        kw = {k: v for k, v in kw.items() if k != "return_tiled"}
    got, want = fn(*args, **kw), ref(*args, **kw)
    if name == "raster_interp":
        return compare(phase, got, want, empty_ok)[0]
    if name == "fused_cover":
        for g, r, out in zip(got, want, ("list", "count", "slot", "covered")):
            if not torch.equal(g, r):
                fail(phase, f"fused_cover: {out} differs from the plain version")
        return 0.0
    if name == "resolve_shade":
        return check_shade(phase, got, want)
    if name.startswith("deferred_shade"):
        return check_deferred(phase, got, want)
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

        def measure_and_hold(pipe, cam, frames, **kw):
            cell = measure(pipe, cam, frames, **kw)
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
        faults += [f"cell {cell} has no sequence fps" for cell in cell_launches
                   if cell != "smoke" and f"{cell}_sequence_dispatch_fps" not in result]
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

    scene = stress_scene(512, 256, 256, 80.0)
    cfg = RenderConfig(W, H, max_instances=2)
    knobs = dict(BASE_KNOBS, brdf_lut_size=BRDF_LUT)
    pipe = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps=TEX_CAPS, **knobs)
    return scene, cfg, dict(BASE_KNOBS), knobs, pipe, cell_camera(cfg)


def cell_camera(cfg):
    """The stress cells' pose: (0, 6, 18), yaw pi, pitch 0.35."""
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera

    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    return cam


def lights1k_cell(dev, knobs):
    """The 1024-light cell on `dev` with the textured cell's `knobs`:
    (scene, render config, the cell's knobs, its pipeline)."""
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    scene = stress_scene(*L1K_CELLS, 256, 80.0, n_lights=L1K_LIGHTS)
    cfg = RenderConfig(W, H, max_instances=2, max_lights=L1K_LIGHTS)
    l1k_knobs = dict(knobs, bin_cap=L1K_BIN_CAP, max_active_lights=L1K_LIGHTS)
    pipe = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps=TEX_CAPS, **l1k_knobs)
    return scene, cfg, l1k_knobs, pipe


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
    view = (cfg.width, cfg.height)
    rows64 = stages.pack_rows64(setup, pipe.buffers, vattrs, view)
    ms = {"geometry": cuda_ms(geometry, 3), "binning": cuda_ms(binning, 3),
          "pack_rows64": cuda_ms(lambda: stages.pack_rows64(setup, pipe.buffers, vattrs, view),
                                 3)}
    return setup, bins, rows64, ms


def timed_passes(pipe, cam, frames: int) -> dict[str, float]:
    """Mean device ms per graph pass (CUDA events around each pass) of
    eager frames (`deferred.eager()`)."""
    from direct12pbrrenderer_tpu_torch.graph import frame_graph as fg
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import eager

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
        with eager():
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


def cluster_members(lists, n_lights: int) -> torch.Tensor:
    """(C, L) bool from (C, 32) cluster lists: light l is on cluster c's list."""
    lists = lists.cpu().long()
    m = torch.zeros((lists.shape[0], n_lights + 1), dtype=torch.bool)
    m[torch.arange(lists.shape[0])[:, None], torch.where(lists >= 0, lists, n_lights)] = True
    return m[:, :n_lights]


def max_errs(got, want) -> tuple[float, float]:
    """(max abs, max rel) difference of two float tensors (any devices)."""
    got, want = got.cpu().double(), want.cpu().double()
    d = (got - want).abs()
    return float(d.max()), float((d / want.abs().clamp(min=1e-30)).max())


def within(got, want, rtol: float, atol: float) -> bool:
    return bool(torch.all((got.cpu() - want.cpu()).abs()
                          <= atol + rtol * want.cpu().abs()))


def reference_fns(dev, smi, pipe, cam, scene, args) -> None:
    """[reference-fns]: the JAX package's reference-only functions, ported
    as plain PyTorch, on the cells' own data on the card (no frame runs
    them). The literal bloom chain against the pipeline's matrix bloom on
    the default frame's pre-bloom HDR image; the per-cluster light lists
    of the 1024-light cell's lights, view and clusters, and their parameter
    rows; the per-pixel cluster index of the default frame's uv and view-z
    planes; the barycentrics on its tri_id plane, from the setup and from
    the packed rows; the 2D bilinear sampler on the scene's 256^2 albedo
    map at the frame's interpolated uv, wrap and clamp; the env prefilter
    from the 256^2 sky's CubeMapTextureData. Each is held to the same call
    on the CPU (bloom to `bloom`), at the bars above."""
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.ops import bloom, clustered, common, ibl, raster
    from direct12pbrrenderer_tpu_torch.ops import raster_cuda
    from direct12pbrrenderer_tpu_torch.ops.shading import view_space_depth
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import eager
    from direct12pbrrenderer_tpu_torch.pipeline.scene_pack import pack_scene

    phase, cpu, parts = "reference-fns", torch.device("cpu"), []
    t_phase = time.perf_counter()

    # ---- bloom: the literal chain against the pipeline's matrix bloom -----
    hdrs, orig = [], bloom.bloom

    def keep(hdr):
        hdrs.append(hdr.clone())
        return orig(hdr)

    bloom.bloom = keep
    try:
        with eager():
            pipe.render(cam, collect_stats=False)
    finally:
        bloom.bloom = orig
    torch.cuda.synchronize()
    if len(hdrs) != 1:
        fail(phase, f"a default frame called bloom {len(hdrs)} times, want 1")
    hdr, = hdrs
    # the frame peaks near the bright-pass knee, so its bloom term is small;
    # the same image scaled to a peak of 12 (the JAX test's range) blooms
    bloom_errs = []
    for img in (hdr, hdr * (12.0 / hdr.max())):
        literal, fused = bloom.bloom_reference(img), bloom.bloom(img)
        err = max_errs(fused, literal)
        if not (torch.isfinite(literal).all() and within(fused, literal, REF_BLOOM_BAR,
                                                         REF_BLOOM_BAR)):
            fail(phase, f"bloom vs bloom_reference on the {tuple(img.shape)} frame (peak "
                 f"{float(img.max()):.2f}): max abs/rel {err} outside rtol/atol "
                 f"{REF_BLOOM_BAR}")
        bloom_errs.append(f"peak {float(img.max()):.2f}, bloom term up to "
                          f"{float((literal - img).abs().max()):.3e}: max abs {err[0]:.3e}, "
                          f"max rel {err[1]:.3e}")
    literal_ms = cuda_ms(lambda: bloom.bloom_reference(hdr), 5)
    fused_ms = cuda_ms(lambda: bloom.bloom(hdr), 5)
    parts.append(f"bloom_reference vs bloom on the default frame's {tuple(hdr.shape)} "
                 f"pre-bloom image ({bloom_errs[0]}) and on it scaled ({bloom_errs[1]}), bar "
                 f"rtol/atol {REF_BLOOM_BAR}; bloom_reference {literal_ms:.4f} ms, bloom "
                 f"{fused_ms:.4f} ms (CUDA events)")
    del hdrs, hdr, img, literal, fused

    # ---- the per-cluster light lists of the 1024-light cell ---------------
    l1k = stress_scene(*L1K_CELLS, 256, 80.0, n_lights=L1K_LIGHTS)
    l1k_cfg = RenderConfig(W, H, max_instances=2, max_lights=L1K_LIGHTS)
    packed = pack_scene(l1k, l1k_cfg, BASE_KNOBS["atlas_max_dim"])
    l1k_cam = cell_camera(l1k_cfg)
    n = packed.light_count
    host = {"bounds": clustered.cluster_bounds(l1k_cfg.fov, l1k_cfg.ratio, l1k_cfg.near,
                                               l1k_cfg.far),
            "view": np.asarray(l1k_cam.view_matrix(), np.float32),
            "pos": packed.light_pos[:n], "radius": packed.light_attenuation[:n, 0],
            "intensity": packed.light_intensity[:n],
            "valid": packed.visible_lights(np.asarray(l1k_cam.frustum_planes(),
                                                      np.float32))[:n],
            "color": packed.light_color[:n], "att": packed.light_attenuation[:n]}
    on = {d: {k: torch.as_tensor(np.ascontiguousarray(v), device=d) for k, v in host.items()}
          for d in (dev, cpu)}

    def cull(d):
        x = on[d]
        return clustered.cull_lights_to_clusters(x["bounds"], x["view"], x["pos"],
                                                 x["radius"], x["intensity"], x["valid"])

    (lists, counts), (lists_c, counts_c) = cull(dev), cull(cpu)
    c = lists.shape[0]
    differ = int((cluster_members(lists, n) != cluster_members(lists_c, n)).sum())
    bar = max(1, int(REF_DECISION_FRAC * c * n))
    if differ > bar or int((counts.cpu() - counts_c).abs().sum()) > differ:
        fail(phase, f"cull_lights_to_clusters: {differ} (cluster, light) decisions differ "
             f"from the CPU's (bar {bar})")
    if int(counts.sum()) == 0:
        fail(phase, "cull_lights_to_clusters listed no light")
    cull_ms = cuda_ms(lambda: cull(dev), 5)

    def params(d, lists_d):
        x = on[d]
        return clustered.build_cluster_light_params(lists_d, x["pos"], x["color"],
                                                    x["intensity"], x["att"])

    rows = params(dev, lists)
    if not torch.equal(rows.cpu(), params(cpu, lists.cpu())):
        fail(phase, "build_cluster_light_params differs from its CPU run")
    parts.append(f"cull_lights_to_clusters of the 1024-light cell ({n} lights, "
                 f"{int(host['valid'].sum())} in the frustum, {c} clusters, a ({c}, {n}, 3) "
                 f"grid): {differ} of {c * n} (cluster, light) decisions differ from the CPU's "
                 f"(bar {bar}), {int(counts.sum())} listed, {int((counts == 32).sum())} "
                 f"clusters at the cap of 32; {cull_ms:.4f} ms (CUDA events); "
                 f"build_cluster_light_params {tuple(rows.shape)} equal to the CPU's")
    del lists, counts, lists_c, counts_c, rows, on, l1k, packed

    # ---- the default frame's planes: cluster index, barycentrics, sampler --
    setup, _, _, width, height, _, _ = args
    tri_id, depth, planes = raster_cuda.rasterize_interp(*args)
    cfg = pipe.config
    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    uv_x, uv_y = (xs + 0.5) / width, (ys + 0.5) / height
    z_view = view_space_depth(depth, cfg.near, cfg.far)

    def index(*xs_):
        return clustered.cluster_index_image(*xs_, cfg.near, cfg.far)

    idx = index(uv_x, uv_y, z_view)
    idx_differ = int((idx.cpu() != index(uv_x.cpu(), uv_y.cpu(), z_view.cpu())).sum())
    idx_bar = max(1, int(REF_DECISION_FRAC * idx.numel()))
    if idx_differ > idx_bar or idx.dtype != torch.int32:
        fail(phase, f"cluster_index_image: {idx_differ} pixels differ from the CPU's "
             f"(bar {idx_bar})")
    parts.append(f"cluster_index_image on the {width}x{height} uv and view-z planes: "
                 f"{idx_differ} pixels differ from the CPU's (bar {idx_bar}), "
                 f"{int(torch.unique(idx).numel())} distinct clusters")

    hit = tri_id >= 0
    ids, px, py = tri_id[hit], xs[hit].float() + 0.5, ys[hit].float() + 0.5
    packed_rows = raster.pack_pixel_data(setup)
    at = raster.barycentrics_at(setup, ids, px, py)
    from_packed = raster.barycentrics_from_packed(packed_rows, ids, px, py)
    setup_c = raster.TriangleSetup(*(t.cpu() for t in setup))
    at_c = raster.barycentrics_at(setup_c, ids.cpu(), px.cpu(), py.cpu())
    errs = []
    for name, a, b, ac in zip(("lam", "lam_persp", "one_over_w"), at, from_packed, at_c):
        if not torch.equal(a, b):
            fail(phase, f"barycentrics_at and barycentrics_from_packed differ in {name}")
        if not (torch.isfinite(a).all() and within(a, ac, REF_BARY_RTOL, REF_BARY_ATOL)):
            fail(phase, f"barycentrics {name}: max abs/rel {max_errs(a, ac)} from the CPU's, "
                 f"bar rtol {REF_BARY_RTOL} / atol {REF_BARY_ATOL}")
        errs.append(max_errs(a, ac)[0])
    parts.append(f"barycentrics on the tri_id plane ({ids.numel()} covered pixels): "
                 f"barycentrics_at == barycentrics_from_packed bit for bit, max abs from the "
                 f"CPU's {max(errs):.3e} (bar rtol {REF_BARY_RTOL} / atol {REF_BARY_ATOL})")
    del at, from_packed, at_c, setup_c, packed_rows

    albedo = scene.models[0].model.materials[0].textures["AlbedoMap"].texture
    tex = torch.as_tensor(albedo.mip_array_rgba(0).astype(np.float32) / 255.0, device=dev)
    u, v = planes[0][hit], planes[1][hit]
    sampled = []
    for wrap in (True, False):
        got = common.sample_texture2d_bilinear(tex, u, v, wrap=wrap)
        want = common.sample_texture2d_bilinear(tex.cpu(), u.cpu(), v.cpu(), wrap=wrap)
        if not within(got, want, REF_SAMPLER_RTOL, 0.0):
            fail(phase, f"sample_texture2d_bilinear wrap={wrap}: max abs/rel "
                 f"{max_errs(got, want)} from the CPU's, bar rtol {REF_SAMPLER_RTOL}")
        sampled.append(f"wrap={wrap} max rel {max_errs(got, want)[1]:.3e}")
    parts.append(f"sample_texture2d_bilinear on the {tuple(tex.shape)} albedo map at the "
                 f"frame's uv ({u.numel()} pixels, u in [{float(u.min()):.2f}, "
                 f"{float(u.max()):.2f}]): " + ", ".join(sampled)
                 + f" from the CPU's (bar rtol {REF_SAMPLER_RTOL})")
    del tri_id, depth, planes, idx, u, v, tex

    # ---- the env prefilter from the sky's CubeMapTextureData --------------
    sky = scene.skybox.cubemap

    def prefilter(size, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ibl.prefilter_env_map_from_texture(sky, out_size=size, device=device)
        return out, time.perf_counter() - t0

    got, card_s = prefilter(REF_PF_SIZE, dev)
    want, cpu_s = prefilter(REF_PF_SIZE, cpu)
    for m, (a, b) in enumerate(zip(got, want)):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.shape != b.shape or not within(a, b, REF_PF_RTOL, REF_PF_ATOL):
            fail(phase, f"prefilter_env_map_from_texture mip {m}: max abs/rel "
                 f"{max_errs(a, b)} from the CPU's, bar rtol {REF_PF_RTOL} / atol "
                 f"{REF_PF_ATOL}")
    pf_err = [max_errs(torch.as_tensor(a), torch.as_tensor(b)) for a, b in zip(got, want)]
    pf_err = (max(e[0] for e in pf_err), max(e[1] for e in pf_err))
    full, full_s = prefilter(min(256, sky.faces[0].width), dev)
    parts.append(f"prefilter_env_map_from_texture of the {sky.faces[0].width}^2 sky at "
                 f"out_size {REF_PF_SIZE}: max abs/rel {pf_err[0]:.3e}/{pf_err[1]:.3e} from "
                 f"the CPU's (bar rtol {REF_PF_RTOL} / atol {REF_PF_ATOL}), {card_s:.3f} s "
                 f"on the card, {cpu_s:.3f} s on the CPU; at the pipeline's out_size "
                 f"{full[0].shape[1]} {full_s:.3f} s on the card")
    say(phase, f"on {smi}: " + "; ".join(parts)
        + f"; the phase took {time.perf_counter() - t_phase:.1f} s")


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


def check_deferred(phase, got, want) -> float:
    """Kernel D's bar, each of its light loops: every output value finite
    and bit-equal to the plain version's (the same formulas, each product
    and sum rounded once to the loop's type, sqrt and division correctly
    rounded, logf and powf as torch computes them on the card). Returns the
    max abs error, 0 when it passes."""
    a, b = got.cpu().numpy(), want.cpu().numpy()
    if not np.isfinite(a).all():
        fail(phase, "non-finite kernel output")
    differ = a.view(np.int32) != b.view(np.int32)
    if differ.any():
        fail(phase, f"{int(differ.sum())} of {differ.size} values differ from the plain "
             f"version ({int(differ[:, 3].sum())} hit counts), max abs error "
             f"{float(np.abs(a - b).max()):.3e}")
    return 0.0


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


def deferred_census(dargs, dkw) -> tuple[dict[str, int], str]:
    """Kernel D's light loop on its inputs, from the plain version run over
    the first s active lights for s = 1..n (its hit counter then says which
    pixels light s hit): lit pixels, (pixel, light) hits, and the bodies a
    full loop evaluates (pixels x lights) against those of a loop that skips
    a light for a warp (32 pixels of a row) none of whose lit pixels it hits.
    Returns ({pixels, lights, lit_hits}, the census line)."""
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
        count = shade_fused.deferred_kernel_reference(c, *dargs[1:], **dict(dkw,
                                                                          light_dtype=None))[:, 3]
        hit = count > prev
        prev = count
        lit_hits += int((hit & mask).sum())
        runs = int((hit & mask).reshape(-1, 32).any(-1).sum())
        warp_lights += runs
        skip.append(1 - runs / n_warps)
    counts = {"pixels": n_px, "lights": n, "lit_hits": lit_hits}
    return counts, (
        f"census: {n_px} pixels, lit share {float(mask.float().mean()):.4f}; (pixel, light) "
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
    `want`, or a kernel in `absent` launched at all (kernel I and D's
    light_dtype instances too, unless `want` names them). Returns (host ms
    per frame, launches)."""
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
    for name in (*absent, *(k for k in INSTANCES if k not in want)):
        if launches[name]:
            fail(phase, f"kernel {name} launched {launches[name]} times, want none")
    return times, launches


def frame_graph_phase(smi: str, pipe, cam, eager_times, binning_ms: float) -> dict[str, int]:
    """[frame-graph]: the default frame as one captured CUDA graph (the
    JAX pipeline's `jax.jit(_frame)`). The pipeline must capture it
    (`captured`); the first `render` captures it (its seconds, the graph
    pool's bytes); frames rendered eagerly (`eager()`) and captured are
    bit-equal over the yaw path with equal FrameStats, no fallback tap and
    the same exposure carry; GRAPH_FRAMES captured frames are timed with
    the launch counts set to 0 just before and read just after (each
    replay adds A 1, B 4, C 1, D 1: the main path's counts); with the sync
    debug mode at "error", SYNC_FRAMES `render(collect_stats=False)` calls
    and a SEQ_FRAMES-frame `render_sequence` raise nothing; that sequence
    is bit-equal to as many `render` calls with the same carry, and both
    are timed; and torch.profiler traces 3 captured frames. Returns the
    launches of the timed frames."""
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import eager

    phase = "frame-graph"
    if not pipe.captured:
        fail(phase, "the default path is not captured on the card: it would run eagerly")
    path = camera_path(cam, GRAPH_FRAMES)
    pipe.captured_frame = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.render(path[0], collect_stats=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    cf = pipe.captured_frame
    if cf is None:
        fail(phase, "the first render did not capture the frame")
    for c in path[:EQUAL_FRAMES]:
        carry = pipe.avg_luminance.clone()
        with eager():
            want = pipe.render(c)
        want_stats, want_avg = pipe.last_stats, pipe.avg_luminance
        pipe.avg_luminance = carry
        got = pipe.render(c)
        if (not torch.equal(got, want) or pipe.last_stats != want_stats
                or not torch.equal(pipe.avg_luminance, want_avg)):
            fail(phase, f"a captured frame differs from the eager one: "
                 f"{int((got != want).any(-1).sum())} pixels, stats {pipe.last_stats} vs "
                 f"{want_stats}, carry {float(pipe.avg_luminance)} vs {float(want_avg)}")
        lost = {k: v for k, v in dataclasses.asdict(pipe.last_stats).items()
                if k in ("bin_overflow", "tex_approx_taps", "env_approx_taps",
                         "lights_truncated", "light_tile_overflow") and v}
        if lost:
            fail(phase, f"the captured frame counts fallbacks {lost}")
    if pipe.captured_frame is not cf:
        fail(phase, "the yaw path captured the frame again")
    want_launches = {"raster_interp": 1, "fused_cover": 4, "resolve_shade": 1,
                     "deferred_shade": 1}
    times, launches = run_frames(phase, pipe, path, {
        k: n * GRAPH_FRAMES for k, n in want_launches.items()})
    if any(launches[k] != n * GRAPH_FRAMES for k, n in want_launches.items()):
        fail(phase, f"{GRAPH_FRAMES} captured frames launched {launches}, want "
             f"{want_launches} a frame")
    seq_path = camera_path(path[-1], SEQ_FRAMES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in path[:SYNC_FRAMES]:
            pipe.render(c, collect_stats=False)
        pipe.render_sequence(seq_path)
    except RuntimeError as e:
        fail(phase, f"a host sync in a captured frame: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    carry = pipe.avg_luminance.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = pipe.render_sequence(seq_path)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    seq_avg = pipe.avg_luminance
    pipe.avg_luminance = carry
    t0 = time.perf_counter()
    loop = [pipe.render(c, collect_stats=False) for c in seq_path]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if not torch.equal(seq, torch.stack(loop)) or not torch.equal(seq_avg, pipe.avg_luminance):
        fail(phase, f"render_sequence differs from {SEQ_FRAMES} render calls: "
             f"{int((seq != torch.stack(loop)).any(-1).sum())} pixels, carry "
             f"{float(seq_avg)} vs {float(pipe.avg_luminance)}")
    del seq, loop
    if pipe.captured_frame is not cf:
        fail(phase, "the path captured the frame again")
    wall, busy, n_act, top = profiled_frames(pipe, path[-1], 3)
    say(phase, f"default path as one captured CUDA graph a frame on {smi}: the first render "
        f"{first_s:.3f} s (its eager warm-up frames and the capture), the capture itself "
        f"{cf.capture_s:.3f} s, graph pool {cf.pool_bytes} bytes; {EQUAL_FRAMES} frames "
        f"bit-equal to eager ones "
        f"(equal FrameStats, carry, no fallback); {GRAPH_FRAMES} captured frames: mean "
        f"{np.mean(times):.2f} ms, p50 {np.median(times):.2f} ms (host clock, synchronized per "
        f"frame) against the eager [frame]'s mean {np.mean(eager_times):.2f} ms, p50 "
        f"{np.median(eager_times):.2f} ms; launches {launches}; sync debug mode \"error\" "
        f"around {SYNC_FRAMES} render(collect_stats=False) calls and a {SEQ_FRAMES}-frame "
        f"render_sequence: no host sync; render_sequence {SEQ_FRAMES / seq_s:.2f} fps "
        f"({seq_s * 1e3 / SEQ_FRAMES:.2f} ms a frame), bit-equal to {SEQ_FRAMES} render calls "
        f"with the same carry, which take {SEQ_FRAMES / loop_s:.2f} fps (one sync after the "
        f"last); binning {binning_ms:.3f} ms (device, CUDA events; the fine pass over every "
        f"cap1 column, no host read); torch.profiler, 3 captured frames: wall {wall:.2f} "
        f"ms/frame, device busy {busy:.2f} ms/frame ({n_act:.0f} device activities), idle "
        f"share {1 - busy / wall:.3f}; top: " + "; ".join(f"{ms:.2f} ms {name[:60]}"
                                                         for ms, name in top))
    return launches


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
    exposure carry. The reference frame renders eagerly (`eager()`): one
    frame, which a capture's warm-up frames would triple; [frame-graph-paths]
    holds the captured all-plain frame to the eager one."""
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import eager

    prev = pipe.avg_luminance.clone()
    ref.avg_luminance = prev.clone()
    a = pipe.render(cam).cpu().numpy().astype(np.float64)
    pipe.avg_luminance = prev
    with eager():
        b = ref.render(cam, collect_stats=False).cpu().numpy().astype(np.float64)
    return float(np.sqrt(np.mean((a / 255.0 - b / 255.0) ** 2))), int((a != b).any(-1).sum())


def free_pipeline(pipe) -> None:
    """Drop `pipe`'s captured frame, and with it its graph pool, then give
    the freed memory back to the card (the caller drops the pipeline)."""
    pipe.captured_frame = None
    gc.collect()
    torch.cuda.empty_cache()


def frame_graph_path(label: str, cell: str, smi: str, pipe, cam) -> None:
    """[frame-graph-paths]: the path `label` (PATH_KERNELS) of `pipe`, on the
    1080p `cell` ("textured" or "lights1k"), as one
    captured CUDA graph a frame. The pipeline must capture it (`captured`);
    the first `render` captures it anew (its seconds, the graph pool's
    bytes); PATH_FRAMES frames over the yaw path rendered eagerly
    (`eager()`) and captured are bit-equal with equal FrameStats and
    exposure carry, and each replay launches what the eager frame launches,
    PATH_KERNELS[label] and no other kernel (the counts read just before
    and just after each frame); both are timed (host clock, synchronized per
    frame, FrameStats read); with the sync debug mode at
    "error" two `render(collect_stats=False)` calls and a PATH_SEQ-frame
    `render_sequence` raise nothing; and torch.profiler traces 3 captured
    frames (device busy, idle share)."""
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import eager

    phase, want = "frame-graph-paths", PATH_KERNELS[label]
    if not pipe.captured:
        fail(phase, f"{label}: the path is not captured on the card")
    path = camera_path(cam, PATH_FRAMES)
    free_pipeline(pipe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.render(path[0], collect_stats=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    cf = pipe.captured_frame
    if cf is None:
        fail(phase, f"{label}: the first render did not capture the frame")

    def timed(c):
        torch.cuda.synchronize()
        n0, t0 = read_launches(), time.perf_counter()
        img = pipe.render(c)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return img, ms, {k: n - n0[k] for k, n in read_launches().items() if n != n0[k]}

    eager_ms, replay_ms = [], []
    for c in path:
        carry = pipe.avg_luminance.clone()
        with eager():
            want_img, ms, eager_launches = timed(c)
        want_stats, want_avg = pipe.last_stats, pipe.avg_luminance
        eager_ms.append(ms)
        pipe.avg_luminance = carry
        got, ms, replay_launches = timed(c)
        replay_ms.append(ms)
        if (not torch.equal(got, want_img) or pipe.last_stats != want_stats
                or not torch.equal(pipe.avg_luminance, want_avg)):
            fail(phase, f"{label}: a captured frame differs from the eager one: "
                 f"{int((got != want_img).any(-1).sum())} pixels, stats {pipe.last_stats} vs "
                 f"{want_stats}, carry {float(pipe.avg_luminance)} vs {float(want_avg)}")
        if not replay_launches == eager_launches == want:
            fail(phase, f"{label}: a replay launched {replay_launches}, the eager frame "
                 f"{eager_launches}, want {want}")
    if pipe.captured_frame is not cf:
        fail(phase, f"{label}: the yaw path captured the frame again")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in path[:2]:
            pipe.render(c, collect_stats=False)
        seq = pipe.render_sequence(camera_path(path[-1], PATH_SEQ))
    except RuntimeError as e:
        fail(phase, f"{label}: a host sync in a captured frame: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if tuple(seq.shape) != (PATH_SEQ, H, W, 3):
        fail(phase, f"{label}: render_sequence gave {tuple(seq.shape)}")
    del seq
    wall, busy, n_act, top = profiled_frames(pipe, path[-1], 3)
    say(phase, f"{label} path of the {cell} cell as one captured CUDA graph a frame on {smi}: "
        f"the first render "
        f"{first_s:.3f} s (its eager warm-up frames and the capture), the capture itself "
        f"{cf.capture_s:.3f} s, graph pool {cf.pool_bytes} bytes; {PATH_FRAMES} frames "
        f"bit-equal to eager ones (equal FrameStats and carry), each replay's launches equal "
        f"to its eager frame's: {want or 'none'}; "
        f"captured mean {np.mean(replay_ms):.2f} ms, p50 {np.median(replay_ms):.2f} ms against "
        f"eager mean {np.mean(eager_ms):.2f} ms, p50 {np.median(eager_ms):.2f} ms (host clock, "
        f"synchronized per frame, FrameStats read); sync debug mode \"error\" around 2 "
        f"render(collect_stats=False) calls and a {PATH_SEQ}-frame render_sequence: no host "
        f"sync; torch.profiler, 3 captured frames: wall {wall:.2f} ms/frame, device busy "
        f"{busy:.2f} ms/frame ({n_act:.0f} device activities), idle share "
        f"{1 - busy / wall:.3f}; top: " + "; ".join(f"{ms:.2f} ms {name[:60]}"
                                                  for ms, name in top))


def frame_bf16(dev, smi, scene, cfg, knobs, pipe, ref, cam) -> None:
    """[frame-bf16]: the textured cell with fused_light_dtype="bfloat16"
    (kernels A, B, C and D's bfloat16 light loop), BF16_FRAMES frames with
    the launch counts set to 0 just before; at the last pose its frame
    against the float32 pipeline's (`pipe`) and the all-plain one (`ref`):
    the rmse is printed, not gated (bfloat16 shading misses the 1e-3 bar,
    shade_pallas.py:221-223); its FrameStats must equal the float32
    pipeline's and its fallback counters be 0 at the cell's caps."""
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    phase = "frame-bf16"
    bf16 = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps=TEX_CAPS,
                                  fused_light_dtype="bfloat16", **knobs)
    path = camera_path(cam, WARMUP + BF16_FRAMES)
    for c in path[:WARMUP]:
        bf16.render(c)
    times, launches = run_frames(phase, bf16, path[WARMUP:], {
        "raster_interp": BF16_FRAMES, "fused_cover": 4 * BF16_FRAMES,
        "resolve_shade": BF16_FRAMES, "deferred_shade": BF16_FRAMES,
        "deferred_shade_bfloat16": BF16_FRAMES}, absent=("env_resolve", "point_lights"))
    pose, keep = path[-1], pipe.avg_luminance.clone()
    rmse_f32, ndiff_f32 = fidelity(bf16, pipe, pose)
    stats = bf16.last_stats
    rmse_plain, ndiff_plain = fidelity(bf16, ref, pose)
    pipe.avg_luminance = keep.clone()
    pipe.render(pose)
    pipe.avg_luminance = keep
    if stats != pipe.last_stats:
        fail(phase, f"FrameStats {stats} differ from the float32 frame's {pipe.last_stats}")
    if stats.tex_approx_taps or stats.env_approx_taps or stats.bin_overflow:
        fail(phase, f"fallbacks at the cell's caps: {stats}")
    if rmse_f32 == 0.0:
        fail(phase, "the bfloat16 frame equals the float32 frame")
    say(phase, f"fused_light_dtype=bfloat16, {BF16_FRAMES} frames {W}x{H} on {smi}: mean "
        f"{np.mean(times):.2f} ms, p50 {np.median(times):.2f} ms (host clock, synchronized per "
        f"frame); kernel launches {launches}; rmse vs the float32 frame {rmse_f32:.6f} "
        f"({ndiff_f32} pixels differ), vs use_pallas=False, use_tex_kernel=False "
        f"{rmse_plain:.6f} ({ndiff_plain} pixels differ; not gated, bar {RMSE_BAR} for the "
        f"float32 frame); FrameStats equal to the float32 frame's: {stats}")


def deferred_dtypes(dev, smi, cam, knobs, measured, bounds) -> dict[str, int]:
    """[kernel-deferred-dtypes]: kernel D's float32, bfloat16 and float16
    light loops on 1920x1080 frames at DTYPE_LIGHTS (64) active lights, D's
    most: the 1024-light cell's scene with max_active_lights=64, which keeps
    the fused deferred pass (kernels A, B, C, D). For each light_dtype, a
    pipeline built with that fused_light_dtype renders DTYPE_FRAMES frames
    with the launch counts set to 0 just before (its instance must launch
    once a frame); then one more frame's D call is recorded, the instance
    held to its plain version bit for bit and timed through its wrapper
    (CUDA events) and alone (torch.profiler), beside its plain version and
    the float32 loop with division (light_dtype None) on the same inputs.
    The bound is the larger of D's byte bound (`deferred_bytes`) and its
    operations: the sphere tests of every (pixel, light) pair at the float32
    rate and, for each (lit pixel, light) hit, the body's operations in the
    loop's type at its rate (float32 67 TFLOP/s; bfloat16 and float16 133.8
    TFLOP/s, the H100 SXM's non-tensor rate, Hopper whitepaper) and its
    float32 ones at 67. Returns each instance's launches."""
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.ops import shade_fused
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    phase = "kernel-deferred-dtypes"
    scene = stress_scene(*L1K_CELLS, 256, 80.0, n_lights=L1K_LIGHTS)
    cfg = RenderConfig(W, H, max_instances=2, max_lights=L1K_LIGHTS)
    d_knobs = dict(knobs, bin_cap=L1K_BIN_CAP, max_active_lights=DTYPE_LIGHTS)
    launches, census = {}, None
    for name, ld in D_DTYPES.items():
        t0 = time.perf_counter()
        pipe = DeferredRenderPipeline(scene, cfg, device=dev, tex_caps=TEX_CAPS,
                                      fused_light_dtype=ld, **d_knobs)
        if not pipe.use_fused_deferred:
            fail(phase, f"max_active_lights={DTYPE_LIGHTS} did not take the fused deferred pass")
        path = camera_path(cam, 1 + DTYPE_FRAMES)
        pipe.render(path[0])
        _, counts = run_frames(phase, pipe, path[1:], {
            "raster_interp": DTYPE_FRAMES, "fused_cover": 4 * DTYPE_FRAMES,
            "resolve_shade": DTYPE_FRAMES, "deferred_shade": DTYPE_FRAMES, name: DTYPE_FRAMES},
            absent=("env_resolve", "point_lights"))
        launches[name] = counts[name]
        with recording(shade_fused, "deferred_kernel") as calls:
            pipe.render(path[-1], collect_stats=False)
            torch.cuda.synchronize()
        (dargs, dkw), = calls
        if int(dargs[0][21]) != DTYPE_LIGHTS or dkw["light_dtype"] != ld:
            fail(phase, f"kernel D ran {int(dargs[0][21])} active lights with light_dtype "
                 f"{dkw['light_dtype']!r}, want {DTYPE_LIGHTS} and {ld!r}")
        if census is None:
            census, census_text = deferred_census(dargs, dkw)

        def call(kw=dkw):
            return shade_fused.deferred_kernel(*dargs, **kw)

        def plain():
            return shade_fused.deferred_kernel_reference(*dargs, **dkw)

        err = check_deferred(phase, call(), plain())
        ms = cuda_ms(call, 20)
        alone, _ = device_ms(call, 10, "deferred_shade")
        plain_ms = cuda_ms(plain, 2)
        f32_ms = cuda_ms(lambda: call(dict(dkw, light_dtype=None)), 20)
        rate = F32_FLOP_PER_S if ld == "float32" else F16_FLOP_PER_S
        t_bytes = deferred_bytes(dargs, dkw)[0] / HBM_BYTES_PER_S * 1e3
        t_ops = (census["pixels"] * census["lights"] * D_SPHERE_OPS / F32_FLOP_PER_S
                 + census["lit_hits"] * (D_BODY_OPS / rate + D_BODY_F32_OPS / F32_FLOP_PER_S)
                 ) * 1e3
        bounds[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        measured[name] = (err, ms, plain_ms, alone)
        say(phase, f"light_dtype={ld} on {smi}: {tuple(dargs[5].shape)} env taps, "
            f"{DTYPE_LIGHTS} active lights, {DTYPE_FRAMES} frames launched it {counts[name]} times (launches "
            f"{counts}); bit-equal to the plain version (max abs diff {err:.3e}); kernel "
            f"{ms:.4f} ms through its wrapper (CUDA events), the kernel alone {alone:.4f} ms "
            f"(torch.profiler), plain {plain_ms:.4f} ms, the float32 loop with division on the "
            f"same inputs {f32_ms:.4f} ms; bound {bounds[name][0]:.4f} ms ({bounds[name][1]}: "
            f"bytes {t_bytes:.4f} ms at 3.35 TB/s; operations {t_ops:.4f} ms, the body at "
            f"{rate / 1e12:.1f} TFLOP/s for {ld}, the sphere tests and the body's float32 "
            f"operations at 67 TFLOP/s); {time.perf_counter() - t0:.1f} s")
        del pipe, calls, dargs
        torch.cuda.empty_cache()
    say(phase, census_text)
    return launches


def checklist_phase(smi, tree) -> None:
    """[checklist]: tools/checklist as a user runs it, in a process of its
    own, on tree T at the App's 1440x960, `--only
    baseline,budget,envbudget,rpc`: one JSON line a check, then ALL. Fails
    on a non-zero exit or a missing line."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "direct12pbrrenderer_tpu_torch.tools.checklist", "--asset-root",
         str(tree), "--width", "1440", "--height", "960", "--only",
         "baseline,budget,envbudget,rpc"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    if proc.returncode:
        fail("checklist", f"exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = {}
    for text in proc.stdout.splitlines():
        if text.startswith("{"):
            line = json.loads(text)
            lines[line.pop("check")] = line
    rec = lines.get("env_census", {}).get("recommended")
    want = ["frame_baseline", "stage_budget_full", "stage_budget_448", "stage_budget_256",
            "env_census", "env_budget_full", f"env_budget_{rec}", "env_budget_48", "rpc", "ALL"]
    missing = [k for k in dict.fromkeys(want) if k not in lines]
    if missing:
        fail("checklist", f"no line for {missing}: {proc.stdout[-3000:]}")
    rpc = lines["rpc"]
    say("checklist", f"python -m direct12pbrrenderer_tpu_torch.tools.checklist --width 1440 "
        f"--height 960 --only baseline,budget,envbudget,rpc on tree T, on {smi}, in "
        f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
            f"{k} {json.dumps(lines[k])}" for k in dict.fromkeys(want) if k != "ALL")
        + f"; the device frame alone is {rpc['exec_only_ms'] / rpc['full_render_ms']:.3f} of "
        f"render()'s time, the camera upload adds "
        f"{rpc['with_upload_ms'] - rpc['exec_only_ms']:.3f} ms, the host-side packing "
        f"{rpc['full_render_ms'] - rpc['with_upload_ms']:.3f} ms")


def lights1k(dev, smi, cam, knobs, base_knobs, measured, bounds) -> dict[str, int]:
    """The 1024-light cell: the JAX bench's lights1k scene with the default
    cell's sky and cache knobs, through the 1024-light path (kernels A, B, C,
    F, G; not D). Checks F and G against their plain versions on one frame's
    recorded inputs, times 16 captured frames, the passes (eager), the
    frame's fidelity, and [frame-graph-paths] on the 1024-light path and on
    its all-plain reference (the dense sweep over all 1024 light rows).
    Adds F's and G's (max abs error, ms, plain ms) to `measured` and their
    bounds to `bounds`; returns the frames' launch counts."""
    from direct12pbrrenderer_tpu_torch.ops import env_resolve_cuda, envcache, lights_cuda
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    t0 = time.perf_counter()
    scene, cfg, l1k_knobs, pipe = lights1k_cell(dev, knobs)
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
    del pipe_j
    frame_graph_path("lights1k", "lights1k", smi, pipe, path[-1])
    free_pipeline(pipe)
    del pipe
    frame_graph_path("all-plain", "lights1k", smi, ref, path[-1])
    free_pipeline(ref)
    return launches


def band_trace(run, frames: int):
    """torch.profiler over `frames` captured band frames (`traced`; every
    rank traces itself, in step with the others): (wall ms a frame, device
    busy ms a frame, NCCL kernels' device ms a frame, whether the trace holds
    every launch of the port's kernels). No second try: a rank that traced
    again alone would leave the others waiting in a collective."""
    spans, launched, wall = traced(run)
    held = {name: sum(1 for n, _ in spans if f"{name}_kernel" in n) for name in KERNELS
            if source_of(name) == name}
    busy = sum(us for _, us in spans) / 1e3 / frames
    nccl = sum(us for n, us in spans if "nccl" in n.lower()) / 1e3 / frames
    return wall / frames, busy, nccl, all(launched[k] == v for k, v in held.items())


def band_rank(mesh, phase: str, smi: str) -> list[str]:
    """One rank of band phase `phase` (BAND_PHASES): builds the cell's
    pipeline on the rank's card and its band frame
    (`frame_sharded.build_sharded_frame`). One eager band frame
    (`deferred.eager()`) with the path's kernel calls recorded holds each
    call to its plain version at the kernels line's bars. The first call
    outside `eager()` captures the frame (on NCCL ranks the whole frame, on
    gloo ranks the band body, whose post chain then runs eagerly); captured
    frames are bit-equal to eager ones over BAND_EQUAL poses with the
    exposure carry chained on the device; BAND_FRAMES captured frames are
    timed with every launch count set to 0 just before and read just after
    (each replay launches the path's kernels once each, B four times), and
    as many eager ones; torch.profiler traces 3 captured frames (idle share;
    on NCCL the collectives' device time; gloo's collectives, eager, are
    timed by `time_collectives`). Rank 0 holds the gathered frame to the
    single-card `render()` of the same pose and carry: bit for bit on one
    rank, at the fidelity bar on several (their bloom products are blocked
    by rows). Fails (the rank exits 1) on a call that disagrees, a captured
    frame that is not bit-equal to the eager one, a capture that did not
    happen or happened again, launches other than the path's, a fallback
    counter above 0, or a frame off its bar. Returns its lines."""
    import importlib

    import torch.distributed as dist

    from direct12pbrrenderer_tpu_torch.parallel import frame_sharded
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import eager

    torch.backends.cuda.matmul.allow_tf32 = False
    cell, _, device, want, absent = BAND_PHASES[phase]
    dev, r, n = mesh.device, mesh.rank, mesh.size
    nccl = dist.get_backend() == "nccl"
    t0 = time.perf_counter()
    if cell == "textured":
        pipe, cam = textured_cell(dev)[4:]
    else:
        pipe = lights1k_cell(dev, dict(BASE_KNOBS, brdf_lut_size=BRDF_LUT))[3]
        cam = cell_camera(pipe.config)
    frame = frame_sharded.build_sharded_frame(mesh, pipe, collect_stats=True)
    carry = pipe.avg_luminance
    build_s = time.perf_counter() - t0
    tag = f"rank {r}/{n} ({dist.get_backend()} on {dev}, y_offset {r * H // n})"

    with contextlib.ExitStack() as stack:   # `recording` renders inside eager()
        calls = {name: stack.enter_context(recording(importlib.import_module(
            f"direct12pbrrenderer_tpu_torch.ops.{KERNELS[name][1]}"), KERNELS[name][2]))
            for name in want}
        frame(*frame_sharded.frame_args(pipe, cam, carry))
        torch.cuda.synchronize()
    held = []
    for name in want:
        if not calls[name]:
            fail(phase, f"{tag}: the band frame made no call of {name}")
        errs = [hold_call(phase, name, a, kw, empty_ok=True) for a, kw in calls[name]]
        held.append(f"{name} {len(errs)} calls, max_abs_err {max(errs):.3e}")
    del calls

    mesh.all_reduce(torch.zeros(1, device=dev))   # the ranks capture together
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    frame(*frame_sharded.frame_args(pipe, cam, carry))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    cap = frame.captured
    if cap is None:
        fail(phase, f"{tag}: the first band frame outside eager() captured nothing")
    whole = len(cap.outputs) == 6   # the whole frame's outputs, or band_render's (rt, stats)
    if whole != nccl:
        fail(phase, f"{tag}: the capture holds {'the whole frame' if whole else 'the band body'}"
             f" on a {dist.get_backend()} rank")
    path = camera_path(cam, BAND_FRAMES)
    for c in path[:BAND_EQUAL]:
        args = frame_sharded.frame_args(pipe, c, carry)
        with eager():
            ref = frame(*args)
        got = frame(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(phase, f"{tag}: a captured band frame differs from the eager one: "
                 f"{int((got[0] != ref[0]).any(-1).sum())} pixels, carry {float(got[1])} vs "
                 f"{float(ref[1])}, stats {[x.tolist() for x in got[2:]]} vs "
                 f"{[x.tolist() for x in ref[2:]]}")
        carry = got[1]
    if frame.captured is not cap:
        fail(phase, f"{tag}: the yaw path captured the band frame again")

    def timed_frames(start):
        nonlocal carry
        carry, times = start, []
        for c in path:
            t2 = time.perf_counter()
            out = frame(*frame_sharded.frame_args(pipe, c, carry))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t2) * 1e3)
            prev, carry = carry, out[1]
        return times, out, prev

    start = carry
    mesh.time_collectives = not nccl
    mesh.all_reduce(torch.zeros(1, device=dev))   # the ranks start the timed frames together
    torch.cuda.synchronize()
    mesh.collective_s = 0.0
    reset_launches()
    times, (rgb8, avg, bin_counts, tex, trunc, env), prev = timed_frames(start)
    launches = read_launches()
    coll_ms = mesh.collective_s * 1e3 / BAND_FRAMES
    mesh.all_reduce(torch.zeros(1, device=dev))
    torch.cuda.synchronize()
    with eager():
        eager_times, eager_out, _ = timed_frames(start)
    mesh.time_collectives = False
    if not all(torch.equal(a, b) for a, b in zip((rgb8, avg, bin_counts, tex, trunc, env),
                                                 eager_out)):
        fail(phase, f"{tag}: the last timed captured band frame differs from the eager one")
    odd = {k: v for k, v in launches.items()
           if v != want.get(k, 0) * BAND_FRAMES and (k in want or k in absent or k == WIDE)}
    if odd:
        fail(phase, f"{tag}: kernel launches {launches} in {BAND_FRAMES} captured band frames, "
             f"want {want} a frame and none of {absent}: off {odd}")

    def traced_frames():
        nonlocal carry
        for c in path[:3]:
            carry = frame(*frame_sharded.frame_args(pipe, c, carry))[1]

    mesh.all_reduce(torch.zeros(1, device=dev))
    torch.cuda.synchronize()
    wall, busy, nccl_ms, complete = band_trace(traced_frames, 3)
    if frame.captured is not cap:
        fail(phase, f"{tag}: the timed frames captured the band frame again")
    counts = bin_counts.cpu().numpy()
    overflow = max(pipe._stats(c, np.zeros(2, np.int64), 0, 0, 0).bin_overflow
                   for c in np.split(counts, n))
    counters = {"bin_overflow": overflow, "tex_approx_taps": int(tex),
                "env_approx_taps": int(env), "light_tile_overflow": int(trunc)}
    if any(counters.values()):
        fail(phase, f"{tag}: FrameStats fallbacks of the band frame {counters} (all must be 0)")
    held_by = "the whole frame" if whole else "the band body; the post chain eager"
    coll = (f"collectives {nccl_ms:.3f} ms a frame (NCCL kernels' device time in the trace, "
            f"{nccl_ms / wall:.3f} of its wall)" if nccl else
            f"collectives {coll_ms:.2f} ms a frame (gloo, eager: host clock, each bracketed by "
            f"synchronizations, the wait for the other ranks included)")
    lines = [f"{tag}: pipeline built in {build_s:.2f} s; one eager band frame's kernel calls "
             f"held to their plain versions at the kernels line's bars: " + "; ".join(held)
             + f"; captured ({held_by}): the first call {first_s:.3f} s (its eager warm-up "
             f"frames and the capture), the capture itself {cap.capture_s:.3f} s, graph pool "
             f"{cap.pool_bytes} bytes; {BAND_EQUAL} captured band frames bit-equal to eager ones "
             f"(carry chained on the device); {BAND_FRAMES} captured band frames: mean "
             f"{np.mean(times):.2f} ms, p50 {np.median(times):.2f} ms against {BAND_FRAMES} eager "
             f"ones: mean {np.mean(eager_times):.2f} ms, p50 {np.median(eager_times):.2f} ms "
             f"(host clock, the ranks started together, synchronized per frame; the last "
             f"frames bit-equal); kernel launches of the captured frames {launches}; {coll}; "
             f"torch.profiler, 3 captured band frames: wall {wall:.2f} ms/frame, device busy "
             f"{busy:.2f} ms/frame (this rank's activities), idle share {1 - busy / wall:.3f}, "
             f"trace {'complete' if complete else 'PARTIAL (some kernels missing)'}; "
             + (f"{n} ranks share one card, so not a scaling figure" if n > 1
                and device != "cuda" else "one card a rank") + f"; on {smi}"]
    full = frame_sharded.gather_rows(mesh, rgb8).cpu().numpy()
    if r:
        return lines
    pipe.avg_luminance = prev   # the carry the last timed frame started from
    single = pipe.render(path[-1]).cpu().numpy()
    stats = pipe.last_stats
    diff = np.abs(full.astype(np.int64) - single.astype(np.int64))
    rmse = float(np.sqrt(np.mean((diff / 255.0) ** 2)))
    off = float((diff > 1).any(-1).mean())
    lit = float((full.max(-1) > 16).mean())
    same_carry = torch.equal(avg, pipe.avg_luminance)
    same_stats = (stats.bin_overflow, stats.tex_approx_taps, stats.env_approx_taps,
                  stats.light_tile_overflow) == tuple(counters.values())
    if full.shape != (H, W, 3) or rmse > RMSE_BAR or off >= 1e-3 or lit < 0.05:
        fail(phase, f"gathered frame {full.shape}, lit {lit:.3f}: rmse vs render() {rmse:.6f} "
             f"(bar {RMSE_BAR}), share of pixels off by more than 1 {off:.2e} (bar 1e-3)")
    if n == 1 and (diff.any() or not same_carry or not same_stats):
        fail(phase, f"the one-rank band frame differs from render(): {int(diff.any(-1).sum())} "
             f"pixels, carry {float(avg)} vs {float(pipe.avg_luminance)}, counters {counters} "
             f"vs {stats}")
    return lines + [f"rank 0: the gathered {W}x{H} frame vs the single-card render() of the "
                    f"same pose and carry: rmse {rmse:.6f} <= {RMSE_BAR}, share of pixels off by "
                    f"more than 1 {off:.2e} < 1e-3, {int(diff.any(-1).sum())} pixels differ; "
                    f"carry {float(avg):.6f} (render() {float(pipe.avg_luminance):.6f}, equal: "
                    f"{same_carry}); band FrameStats fallbacks {counters} (render()'s equal: "
                    f"{same_stats}); lit {lit:.3f}"]


def band_phases(smi: str, phases=("sharded", "sharded-nccl", "sharded-lights1k")) -> None:
    """The band frame (parallel/frame_sharded.py) on the card: each of
    `phases` (BAND_PHASES) launches its ranks (`frame_sharded.launch`, which
    spawns them; the kernels are built already) and prints each rank's
    lines. A rank that fails fails the phase."""
    from torch.multiprocessing.spawn import ProcessException

    from direct12pbrrenderer_tpu_torch.parallel import frame_sharded

    for phase in phases:
        cell, n, device, _, _ = BAND_PHASES[phase]
        n = n or torch.cuda.device_count()
        t0 = time.perf_counter()
        try:
            ranks = frame_sharded.launch(n, band_rank, phase, smi, device=device)
        except ProcessException as e:
            fail(phase, f"a rank failed: {e}")
        for lines in ranks:
            for line in lines:
                say(phase, line)
        say(phase, f"{cell} cell, {n} {frame_sharded.backend_for(n, device)} rank(s) on "
            f"{device}: passed in {time.perf_counter() - t0:.1f} s")


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
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.ops import (cover_cuda, envcache, resolve_shade_cuda,
                                                   shade_fused, texcache)
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer_tpu_torch.resource.loader import ResourceLoader
    from direct12pbrrenderer_tpu_torch.resource.resources import CubeMapResource, ModelResource
    from direct12pbrrenderer_tpu_torch.scene.scene import Scene, SceneModel
    from direct12pbrrenderer_tpu_torch.tools import tap_census

    phase = "asset-auto"
    build = ROOT / "build"
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


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no socket holds now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def console(root, *argv) -> str:
    """One command of the port's console as a user runs it, in a process
    of its own; returns what it printed."""
    proc = subprocess.run([sys.executable, "-m", "direct12pbrrenderer_tpu_torch.app.console",
                           "--asset-root", str(root), *argv], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    if proc.returncode:
        fail("app-tree", f"console {argv[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout.strip()


def app_tree(root, src, cells, grid) -> dict:
    """Tree `root` built as a user builds one, each console command a
    process of its own: a 256^2 procedural sky (CreateProceduralSky), the
    sphere (CreateSphereModel), tools/stress_scene's terrain at `cells`
    written as OBJ/MTL with its albedo PNG and imported (ImportModel); then
    a Scene JSON at the App's default scene path: the terrain put back at
    its centroid, the sphere instanced on a `grid` (x by z, 2.5 apart, 5
    apart in depth) over the part of the terrain in view of the App's pose,
    the terrain's 8 lights and the sky. Returns the tree's counts."""
    from direct12pbrrenderer_tpu_torch.resource.loader import ResourceLoader
    from direct12pbrrenderer_tpu_torch.scene.scene import Scene, SceneModel

    printed = [console(root, "CreateProceduralSky", "-s", "256", "-o", "Asset/SkyBox/Sky"),
               console(root, "CreateSphereModel", "-o", "Asset/Model/Sphere")]
    content = stress_scene(*cells, 16, 80.0)
    src.mkdir()
    centroid = write_asset_sources(src, content)
    printed.append(console(root, "ImportModel", "-i", str(src / "terrain.obj"), "-o",
                           "Asset/Terrain/Terrain"))
    ld = ResourceLoader.set_instance(ResourceLoader(root))
    scene = Scene("Asset/Scene/main")
    terrain = SceneModel("terrain")
    terrain.model_file_path = "Asset/Terrain/Terrain_Model"
    terrain.translation = centroid
    scene.add_model(terrain)
    nx, nz = grid
    for i in range(nx):
        for j in range(nz):
            sm = SceneModel(f"sphere_{i}_{j}")
            sm.model_file_path = "Asset/Model/Sphere/sphere_Model"
            sm.translation = np.array([(i - (nx - 1) / 2) * 2.5, 2.0, 6.0 - 5.0 * j], np.float32)
            scene.add_model(sm)
    for light in content.lights:
        scene.add_light(light)
    scene.skybox_path = "Asset/SkyBox/Sky"
    ld.dump_resource(scene)
    del content
    loaded = ResourceLoader.set_instance(ResourceLoader(root)).load_resource(
        Scene, "Asset/Scene/main.json")
    meshes = [sm.model.mesh_resource.mesh for sm in loaded.models]
    return {"printed": printed, "models": len(loaded.models), "lights": len(loaded.lights),
            "tris": sum(m.index_count // 3 for m in meshes),
            "vertices": sum(m.vertex_count for m in meshes),
            "sky": loaded.skybox is not None and loaded.skybox.cubemap is not None,
            "albedo": loaded.models[0].model.materials[0].get_parameter("UseAlbedoMap"),
            "files": sum(1 for p in root.rglob("*") if p.is_file()),
            "mb": sum(p.stat().st_size for p in root.rglob("*") if p.is_file()) / 1e6}


def app_config(tree):
    """The App's configuration of the [app] cell: the AppConfig defaults at
    the cell's pose."""
    from direct12pbrrenderer_tpu_torch.app.app import AppConfig

    return AppConfig(asset_root=str(tree), camera_pos=APP_POSE[0], camera_yaw_deg=APP_POSE[1],
                     camera_pitch_deg=APP_POSE[2], orbit_deg_per_frame=APP_POSE[3])


def app_cli_argv(tree, out_dir) -> list[str]:
    """`python -m direct12pbrrenderer_tpu_torch.app` at `app_config`'s pose."""
    (x, y, z), yaw, pitch, orbit = APP_POSE
    return [sys.executable, "-m", "direct12pbrrenderer_tpu_torch.app", "--asset-root", str(tree),
            "--camera", str(x), str(y), str(z), "--yaw", str(yaw), "--pitch", str(pitch),
            "--orbit", str(orbit), "--out", str(out_dir)]


@contextlib.contextmanager
def plain_kernels():
    """While the block runs, the App path's kernels (A, B, C, D) run their
    plain versions on the card: each wrapper's launch is swapped for the
    plain PyTorch function that `hold_call` holds it to. The frame keeps
    every knob's semantics (the raster's two-pass cut lists, the caches'
    page caps and their fallbacks); only the kernels' arithmetic changes.
    Frames rendered meanwhile run eagerly (a replay calls no wrapper)."""
    from unittest import mock

    from direct12pbrrenderer_tpu_torch.ops import (cover_cuda, raster_cuda, resolve_shade_cuda,
                                                   shade_fused)
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import eager

    with contextlib.ExitStack() as stack:
        stack.enter_context(eager())
        for module, name, plain in (
                (raster_cuda, "_launch", raster_cuda.rasterize_interp_reference),
                (cover_cuda, "fused_cover", cover_cuda.fused_cover_reference),
                (resolve_shade_cuda, "resolve_shade", resolve_shade_cuda.resolve_shade_reference),
                (shade_fused, "deferred_kernel", shade_fused.deferred_kernel_reference)):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def app_fidelity(app, pipe, dev) -> str:
    """The App's frame at the AppConfig defaults and the App's pose, gated
    at RMSE_BAR, with equal FrameStats, against the same pipeline with its
    kernels' plain versions (`plain_kernels`; none may launch). Then
    against the all-plain pipeline (`use_pallas=False, use_tex_kernel=False`,
    the same content knobs), reported with that gate's verdict: two losses
    that the AppConfig knobs make, as in the JAX package, and that
    FrameStats counts, are not the all-plain pipeline's. The two-pass
    raster's hot set (raster_caps) can miss, and tiles beyond the hot_k
    fullest then fold only their first cap_small entries (bin_overflow); the
    env cache's BRDF LUT tap group has a fixed page cap of 32, whose overflow
    falls back (env_approx_taps). A miss of that bar with no loss counted
    fails. Returns the line to print."""
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline, eager

    cfg, cam = app.cfg, app.camera
    carry = pipe.avg_luminance.clone()
    keep = read_launches()
    frames, stats = [], []
    for plain in (False, True):
        pipe.avg_luminance = carry.clone()
        torch.cuda.synchronize()
        reset_launches()
        with plain_kernels() if plain else contextlib.nullcontext():
            frames.append(pipe.render(cam).cpu().numpy().astype(np.float64))
        stats.append(pipe.last_stats)
        if plain and any(read_launches().values()):
            fail("app", f"the plain versions' frame launched kernels: {read_launches()}")
    set_launches(keep)
    pipe.avg_luminance = carry
    rmse = float(np.sqrt(np.mean((frames[0] / 255.0 - frames[1] / 255.0) ** 2)))
    ndiff = int((frames[0] != frames[1]).any(-1).sum())
    if rmse > RMSE_BAR or stats[0] != stats[1]:
        fail("app", f"the App's frame vs its kernels' plain versions: rmse {rmse:.6f} (bar "
             f"{RMSE_BAR}), {ndiff} pixels differ, stats {stats[0]} vs {stats[1]}")
    ref = DeferredRenderPipeline(app.scene, pipe.config, use_pallas=False, use_tex_kernel=False,
                                 device=dev, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                                 bin_cap=cfg.bin_cap, atlas_max_dim=cfg.atlas_max_dim,
                                 prefilter_size=cfg.prefilter_size)
    ref.avg_luminance = carry.clone()
    with eager():   # one reference frame: no capture
        b = ref.render(cam, collect_stats=False).cpu().numpy().astype(np.float64)
    del ref
    rmse_plain = float(np.sqrt(np.mean((frames[0] / 255.0 - b / 255.0) ** 2)))
    ndiff_plain = int((frames[0] != b).any(-1).sum())
    lost = {k: getattr(stats[0], k) for k in ("bin_overflow", "env_approx_taps",
                                              "tex_approx_taps") if getattr(stats[0], k)}
    if rmse_plain > RMSE_BAR and not lost:
        fail("app", f"frame vs use_pallas=False, use_tex_kernel=False: rmse {rmse_plain:.6f} "
             f"above {RMSE_BAR} with no loss counted ({stats[0]})")
    verdict = ("passes" if rmse_plain <= RMSE_BAR else
               f"FAILS at the AppConfig defaults, with the losses counted {lost} "
               f"(ROADMAP.md section 3)")
    return (f"frame at the AppConfig defaults vs its kernels' plain versions (gate <= "
            f"{RMSE_BAR}, equal FrameStats): rmse {rmse:.3e}, {ndiff} pixels differ, "
            f"{stats[0]}; vs use_pallas=False, use_tex_kernel=False: rmse {rmse_plain:.6f}, "
            f"{ndiff_plain} pixels differ, gate <= {RMSE_BAR} {verdict}")


def app_phase(dev, smi, tree, out_dir):
    """[app]: the App as a user runs it, 60 frames at the AppConfig defaults
    through its command line, then the same App in this process: its
    kernel launches per frame, one frame's kernel calls held to their plain
    versions, its first frame bit-equal to a pipeline built directly with
    the same knobs, its frame against its kernels' plain versions and the
    all-plain pipeline (`app_fidelity`), the bin census, and device busy
    and idle share over 8 traced frames. Returns the App."""
    from PIL import Image

    from direct12pbrrenderer_tpu_torch.app.app import App
    from direct12pbrrenderer_tpu_torch.ops import (cover_cuda, raster_cuda, resolve_shade_cuda,
                                                   shade_fused)
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    phase = "app"
    cfg = app_config(tree)
    t0 = time.perf_counter()
    argv = app_cli_argv(tree, out_dir)
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=900, cwd=ROOT)
    cli_s = time.perf_counter() - t0
    if proc.returncode:
        fail(phase, f"the App's command line exited {proc.returncode}: {proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    pngs = sorted(out_dir.glob("frame_*.png"))
    lit = []
    for p in pngs:
        img = np.asarray(Image.open(p))
        if img.shape != (cfg.height, cfg.width, 3):
            fail(phase, f"{p.name} is {img.shape}, want {(cfg.height, cfg.width, 3)}")
        lit.append(float((img.max(-1) > 16).mean()))
    if (len(pngs), report["frames"], report["resolution"]) != (
            cfg.frames, cfg.frames, f"{cfg.width}x{cfg.height}") or min(lit) < 0.05:
        fail(phase, f"{len(pngs)} PNGs, report {report}, least lit share {min(lit):.3f}")
    say(phase, f"command line `python -m direct12pbrrenderer_tpu_torch.app --asset-root T "
        f"{' '.join(argv[5:-2])} --out D` on {smi} in {cli_s:.1f} s: {json.dumps(report)}; "
        f"{len(pngs)} PNGs of {cfg.width}x{cfg.height}, lit share {min(lit):.3f}-{max(lit):.3f}")

    t0 = time.perf_counter()
    app = App(cfg)
    pipe, cam = app.pipeline, app.camera
    if not (pipe.use_pallas and pipe.use_fused_gbuffer and pipe.use_fused_deferred
            and pipe.render_w > cfg.width):
        fail(phase, f"the App's pipeline on the card is not the fused kernel path on a padded "
             f"canvas ({pipe.render_w}x{pipe.render_h})")
    direct = DeferredRenderPipeline(
        app.scene, pipe.config, tile_h=cfg.tile_h, tile_w=cfg.tile_w, bin_cap=cfg.bin_cap,
        atlas_max_dim=cfg.atlas_max_dim, prefilter_size=cfg.prefilter_size,
        tex_caps=cfg.tex_caps, tex_cascade=cfg.tex_cascade, env_budget=cfg.env_budget,
        raster_caps=cfg.raster_caps, device=dev)
    first, want = pipe.render(cam), direct.render(cam)
    if not torch.equal(first, want) or pipe.last_stats != direct.last_stats:
        fail(phase, f"the App's first frame differs from the directly built pipeline's in "
             f"{int((first != want).any(-1).sum())} pixels; stats {pipe.last_stats} vs "
             f"{direct.last_stats}")
    del direct, first, want
    build_s = time.perf_counter() - t0

    # kernel launches per frame along the App's orbit, counts reset just before
    path, c = [], cam
    for _ in range(APP_COUNTED):
        c = copy.deepcopy(c)
        c.rotate(0.0, math.radians(APP_POSE[3]), 0.0)
        path.append(c)
    torch.cuda.synchronize()
    reset_launches()
    for c in path:
        pipe.render(c, collect_stats=False)
    torch.cuda.synchronize()
    launches = read_launches()
    want_launches = {k: APP_KERNELS.get(k, 0) * APP_COUNTED for k in KERNELS}
    if launches != want_launches:
        fail(phase, f"kernel launches in {APP_COUNTED} frames {launches}, want {want_launches}")

    # one frame's kernel calls held to their plain versions
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(recording(mod, fn)) for name, mod, fn in (
            ("raster_interp", raster_cuda, "rasterize_interp"),
            ("fused_cover", cover_cuda, "fused_cover"),
            ("resolve_shade", resolve_shade_cuda, "resolve_shade"),
            ("deferred_shade", shade_fused, "deferred_kernel"))}
        pipe.render(cam, collect_stats=False)
        torch.cuda.synchronize()
    held = []
    for name, recorded in calls.items():
        errs = [hold_call(phase, name, args, kw) for args, kw in recorded]
        held.append(f"{name} {len(errs)} calls, max_abs_err {max(errs):.3e}")
    covers = [(max(a[2]), a[3]) for a, _ in calls["fused_cover"]]
    del calls

    # the bin census of the pose, against the two-pass split's caps
    _, bins, _, _ = frame_inputs(pipe, cam)
    counts = bins.counts.cpu().numpy()
    cap_small, hot_k = cfg.raster_caps
    census = (f"bin counts over {counts.size} tiles p50 {np.percentile(counts, 50):.0f} p90 "
              f"{np.percentile(counts, 90):.0f} p99 {np.percentile(counts, 99):.0f} max "
              f"{counts.max()}, {int((counts > cap_small).sum())} tiles above cap_small "
              f"{cap_small} (hot_k {hot_k}), {int((counts > cfg.bin_cap).sum())} above bin_cap "
              f"{cfg.bin_cap}")
    del bins

    gate = app_fidelity(app, pipe, dev)
    wall, busy, n_act, top = profiled_frames(pipe, cam, 8)
    say(phase, f"in process, the same App on {smi}: pipeline build and the first frame bit-equal "
        f"to a DeferredRenderPipeline built directly with the same knobs {build_s:.1f} s; "
        f"kernel launches in {APP_COUNTED} frames of the orbit {launches} (per frame A 1, B 5: "
        f"texture fallback, lo, hi, the cascade, env; C 1, D 1); covers (cap, block_cap) "
        f"{covers}; one frame's kernel calls held to their plain versions at the kernels "
        f"line's bars: " + "; ".join(held))
    say(phase, f"{gate}; {census}; frame ms from the "
        f"command line's report: mean {report['mean_frame_ms']}, p50 {report['p50_frame_ms']} "
        f"(host clock, synchronized per frame by the .cpu() copy), compile_s "
        f"{report['compile_s']}; torch.profiler over 8 frames: wall {wall:.2f} ms/frame, device "
        f"busy {busy:.2f} ms/frame ({n_act:.0f} device activities), idle share "
        f"{1 - busy / wall:.3f}; top: " + "; ".join(f"{ms:.2f} ms {name[:60]}"
                                                    for ms, name in top))
    return app


def viewer_child(tree: str) -> None:
    """[viewer], run in a process of its own (`python -c "import chip_smoke;
    chip_smoke.viewer_child(TREE)"`) so that the first frame, and with it
    the first use of every kernel (`kernels/build.load`, the persistent grid
    caches), comes on one of the viewer's HTTP handler threads: the App at
    the [app] cell's configuration, `viewer.serve(app, port)` on a free
    ephemeral port on a daemon thread, GET /, then POST /step with w, a
    right-drag of 100 px, and no input; the first step captures the App's
    frame there (`pipe.captured`). Prints one JSON line; exits non-zero on a
    failed check."""
    import threading
    import urllib.request

    from direct12pbrrenderer_tpu_torch.app import viewer
    from direct12pbrrenderer_tpu_torch.app.app import App
    from direct12pbrrenderer_tpu_torch.kernels import build
    from direct12pbrrenderer_tpu_torch.pipeline import deferred

    phase = "viewer"
    app = App(app_config(tree))
    if build._LOADED:
        fail(phase, f"kernels {sorted(build._LOADED)} loaded before the first frame")
    threads, render = [], app.pipeline.render

    def render_on(*args, **kwargs):
        threads.append(threading.current_thread())
        return render(*args, **kwargs)

    app.pipeline.render = render_on
    port = free_port()
    threading.Thread(target=viewer.serve, args=(app, port), daemon=True).start()
    page = b""
    for _ in range(300):
        try:
            page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5).read()
            break
        except OSError:
            time.sleep(0.1)
    if b"/step" not in page:
        fail(phase, "GET / did not serve the viewer's page")

    def step(payload):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/step",
                                     data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            jpeg, caption = r.read(), json.loads(r.headers["X-Stats"])["caption"]
        return jpeg, caption, (time.perf_counter() - t0) * 1e3

    cam = app.camera
    reset_launches()
    pos0 = np.asarray(cam.position).copy()
    jpeg_w, _, ms_w = step({"w": True})
    pos1 = np.asarray(cam.position).copy()
    view1 = np.asarray(cam.view_matrix()).copy()
    jpeg_r, _, ms_r = step({"rmb": True, "dx": 100, "dy": 0})
    pos2 = np.asarray(cam.position).copy()
    jpeg_n, caption, ms_n = step({})
    launches = read_launches()
    moved = float(np.linalg.norm(pos1 - pos0))
    checks = {
        "jpeg magic": all(j[:2] == b"\xff\xd8" for j in (jpeg_w, jpeg_r, jpeg_n)),
        "w moves 0.05": abs(moved - 0.05) < 1e-5,
        "a turn leaves the position": bool(np.allclose(pos1, pos2)),
        "a turn turns": not np.allclose(np.asarray(cam.view_matrix()), view1),
        "caption": "fps" in caption and "drawed" in caption,
        "frames on handler threads": len(threads) == 3
        and threading.main_thread() not in threads,
        "kernels first loaded there": sorted(build._LOADED) == sorted(
            source_of(k) for k, n in APP_KERNELS.items() if n),
        # the first frame captures the App's frame: its eager warm-up frames launch too
        "captured there": app.pipeline.captured_frame is not None,
        "launches": launches == {k: APP_KERNELS.get(k, 0) * (3 + deferred.CAPTURE_WARMUP)
                                 for k in KERNELS},
    }
    print(json.dumps({"checks": checks, "moved": moved, "caption": caption,
                      "jpeg_bytes": [len(jpeg_w), len(jpeg_r), len(jpeg_n)],
                      "step_ms": [round(ms_w, 1), round(ms_r, 1), round(ms_n, 1)],
                      "threads": sorted({t.name for t in threads}), "launches": launches}))
    if not all(checks.values()):
        sys.exit(1)


def viewer_phase(smi, tree) -> None:
    """[viewer]: `viewer_child` in a process of its own."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                           "chip_smoke.viewer_child(sys.argv[1])", str(tree)],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode or not lines:
        fail("viewer", f"exited {proc.returncode}: {lines[-1:] or ''} {proc.stderr[-3000:]}")
    say("viewer", f"a fresh process on {smi}, its first frame and first kernel use on the "
        f"viewer's handler threads, {time.perf_counter() - t0:.1f} s: {lines[-1]}")


def profile_app_phase(smi, app) -> None:
    """[profile-app]: tools/profile.profile_pipeline on the App's pipeline
    and camera, 5 iterations a stage (CUDA events)."""
    from direct12pbrrenderer_tpu_torch.tools import profile

    t0 = time.perf_counter()
    t = profile.profile_pipeline(app.pipeline, app.camera, iters=5)
    frames = ["full_frame", "full_frame_eager"]   # captured, and inside eager()
    if any(v < 0 for v in t.values()) or list(t)[-2:] != frames:
        fail("profile-app", f"stage timings {t}")
    total = sum(v for k, v in t.items() if k not in frames)
    say("profile-app", f"tools/profile.profile_pipeline on the App's pipeline, median device ms "
        f"per stage (CUDA events) on {smi}: " + ", ".join(f"{k} {v:.2f}" for k, v in t.items()
                                                          if k not in frames)
        + f"; sum of stages {total:.2f}, full_frame {t['full_frame']:.2f} (captured), "
        f"full_frame_eager {t['full_frame_eager']:.2f}; {time.perf_counter() - t0:.1f} s")


def census_main_phase(smi, tree) -> None:
    """[census-main]: tools/tap_census.main as a user runs it on the tree, at
    1440x960 over 8 poses, with the launch counts reset just before: each
    pose's texture and env censuses raster with kernel H, 16 launches."""
    from direct12pbrrenderer_tpu_torch.tools import tap_census

    out = io.StringIO()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    with contextlib.redirect_stdout(out):
        tap_census.main(["--asset-root", str(tree), "--width", "1440", "--height", "960",
                         "--poses", "8"])
    torch.cuda.synchronize()
    launches = read_launches()
    lines = out.getvalue().strip().splitlines()
    if launches["raster_depth"] != 16 or len(lines) != 17:
        fail("census-main", f"kernel launches {launches} (want raster_depth 16), {len(lines)} "
             f"lines printed (want 8 + 8 + 1)")
    say("census-main", f"tap_census.main --width 1440 --height 960 --poses 8 on {smi} in "
        f"{time.perf_counter() - t0:.1f} s; kernel launches {launches}; {lines[0]}; {lines[8]}; "
        f"{lines[-1]}")


def app_cells(dev, smi, tmp) -> None:
    """[app-tree], [app], [viewer], [profile-app], [census-main],
    [checklist] on a tree under `tmp`."""
    t0 = time.perf_counter()
    tree = tmp / "T"
    info = app_tree(tree, tmp / "src", APP_CELLS, APP_GRID)
    # the OBJ importer writes three vertices a triangle (it welds none), so
    # the terrain's 2 cells_x cells_y triangles bring 6 cells_x cells_y
    # vertices; the console's sphere has 1,472 triangles and 761 vertices
    n_terrain, n_spheres = APP_CELLS[0] * APP_CELLS[1] * 2, APP_GRID[0] * APP_GRID[1]
    want = {"models": 1 + n_spheres, "lights": 8, "sky": True, "albedo": True,
            "tris": n_terrain + n_spheres * 1472, "vertices": 3 * n_terrain + n_spheres * 761}
    got = {k: info[k] for k in want}
    if got != want:
        fail("app-tree", f"tree holds {got}, want {want}")
    say("app-tree", f"tree T built with the port's console, one process a command, and a Scene "
        f"JSON at Asset/Scene/main.json: {got}; {info['files']} files, {info['mb']:.1f} MB; "
        f"console: {' | '.join(info['printed'])}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    app = app_phase(dev, smi, tree, tmp / "frames")
    say("app", f"{time.perf_counter() - t0:.1f} s")
    viewer_phase(smi, tree)
    profile_app_phase(smi, app)
    del app
    torch.cuda.empty_cache()
    census_main_phase(smi, tree)
    torch.cuda.empty_cache()
    checklist_phase(smi, tree)


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


def planar_tex_cells(dev, smi, scene, cfg, cam, knobs, pipe, cover_calls, measured,
                     bounds) -> dict[str, int]:
    """The planar texture-cache, cap-156 and anisotropic configurations of
    the textured stress cell. Checks kernel A at the 24x160 tile, E and I
    against their plain versions (and I's plain version against B at caps
    up to 128 on the default frame's recorded covers), times each path's
    captured frames, holds each frame against its all-plain pipeline, and
    runs [frame-graph-paths] on the planar-tex and anisotropic paths. Adds
    E's and I's numbers to `measured` and `bounds`; returns their launches
    on their paths."""
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
    del ref
    frame_graph_path("planar-tex", "textured", smi, ptex, path[-1])
    free_pipeline(ptex)
    del ptex

    # ---- the cap-156 frame: B four times, one of them wide (kernel I) ---------
    cap.render(cam, collect_stats=False)   # the frame's capture and its warm-up frames
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
    del ref
    frame_graph_path("anisotropic", "textured", smi, aniso, apath[-1])
    free_pipeline(aniso)
    del aniso
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on the GPU.")
    ap.add_argument("--cards", action="store_true",
                    help="only the band frame of the textured cell: one NCCL rank, then one "
                         "NCCL rank on each card of the machine")
    cards = ap.parse_args(argv).cards
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi_all = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
    smi = smi_all[0]
    say("device", f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | "
        f"nvidia-smi: {' | '.join(smi_all)} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    if cards:
        build_kernels()
        band_phases(smi, ("sharded-nccl", "sharded-cards"))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    from direct12pbrrenderer_tpu_torch.ops import (
        cover_cuda,
        gbuffer,
        raster,
        raster_cuda,
        resolve_shade_cuda,
        shade_fused,
    )
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline, eager

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

    err_d = check_deferred("kernel-deferred", deferred(),
                           shade_fused.deferred_kernel_reference(*dargs, **dkw))
    ms_d = cuda_ms(deferred, 20)
    cold_d = cold_ms(deferred, 20)
    host_d = host_ms(deferred, 20)
    alone_d, busy_d = device_ms(deferred, 10, "deferred_shade")
    plain_ms_d = cuda_ms(lambda: shade_fused.deferred_kernel_reference(*dargs, **dkw), 3)
    # the words the output reads (deferred_bytes); about 60 flops per pixel
    # and active light. The earlier bound read every word of every input.
    rec_d = dargs[5]
    px_d = rec_d.shape[0] * rec_d.shape[2] * 128
    bytes_d, every_word_d = deferred_bytes(dargs, dkw)
    reads_d = deferred_reads(dargs, dkw)
    bounds["deferred_shade"] = bound(bytes_d, px_d * float(dargs[0][21]) * 60)
    EARLIER_BOUNDS["deferred_shade"] = bound(every_word_d, px_d * float(dargs[0][21]) * 60)[0]
    lit_d = dargs[8][:, 10] > 0.5
    taps_lit = float(reads_d["rec"].sum(1)[lit_d].float().mean())
    ops_d = only_kernel("kernel-deferred", deferred, "deferred_shade")
    # the light_dtype instances on these inputs, where 64% of the light
    # bodies run (comparison launches: the paths' counts are reset later)
    dtype_ms = {}
    for ld in D_DTYPES.values():
        kw = dict(dkw, light_dtype=ld)
        check_deferred("kernel-deferred", shade_fused.deferred_kernel(*dargs, **kw),
                       shade_fused.deferred_kernel_reference(*dargs, **kw))
        dtype_ms[ld] = cuda_ms(lambda: shade_fused.deferred_kernel(*dargs, **kw), 20)
    say("kernel-deferred", f"{tuple(dargs[5].shape)} env taps, {int(dargs[0][21])} active "
        f"lights: ok (bit-equal to the plain version, max abs diff {err_d:.3e}), kernel "
        f"{ms_d:.4f} ms through its wrapper (CUDA events; "
        f"{cold_d:.4f} ms with the L2 evicted before each call; host time {host_d:.4f} ms a "
        f"call), the kernel alone "
        f"{alone_d:.4f} ms, the rest of the call's device work (layout copies) "
        f"{busy_d - alone_d:.4f} ms (torch.profiler), plain {plain_ms_d:.4f} ms, bound "
        f"{bounds['deferred_shade'][0]:.4f} ms ({bounds['deferred_shade'][1]}: the words the "
        f"output reads; over every word of every input {EARLIER_BOUNDS['deferred_shade']:.4f} "
        f"ms); env taps the output reads: {taps_lit:.3f} per lit pixel (the kernel gathers "
        f"{rec_d.shape[1] - 1}), 1 per background pixel; one call dispatches {ops_d} and "
        f"traces only its kernel; planes' strides {plane_layouts(dargs[5:])}; "
        f"{deferred_census(dargs, dkw)[1]}; the light_dtype instances on these inputs, each "
        f"bit-equal to its plain version, through the wrapper (CUDA events): "
        + ", ".join(f"{ld} {ms:.4f} ms" for ld, ms in dtype_ms.items()))
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

    # ---- the JAX package's reference-only functions on the card -----------
    reference_fns(dev, smi, pipe, cam, scene, args)

    # ---- the default frame through kernels A, B, C, D, run eagerly ----------
    path = camera_path(cam, WARMUP + FRAMES)
    with eager():
        for c in path[:WARMUP]:
            pipe.render(c)
        times, launches = run_frames("frame", pipe, path[WARMUP:], {
            "raster_interp": FRAMES, "fused_cover": 4 * FRAMES, "resolve_shade": FRAMES,
            "deferred_shade": FRAMES})
        frame_line = check_frame("frame", pipe, path[-1])
    say("frame", f"default path run eagerly (`eager()`), {FRAMES} frames {W}x{H}: mean "
        f"{np.mean(times):.2f} ms, p50 {np.median(times):.2f} ms (host clock, synchronized per "
        f"frame); kernel launches {launches}; {frame_line}")
    per_pass = timed_passes(pipe, path[-1], 3)
    say("passes", "default path run eagerly, mean device ms per pass (CUDA events): "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_pass.items()))
    with eager():
        wall, busy, n_act, top = profiled_frames(pipe, path[-1], 3)
    if busy <= 0:
        fail("profile", "torch.profiler recorded no device time")
    say("profile", f"default path run eagerly, torch.profiler, 3 frames: wall {wall:.2f} "
        f"ms/frame, device busy {busy:.2f} ms/frame ({n_act:.0f} device activities), idle "
        f"share {1 - busy / wall:.3f}; top: " + "; ".join(f"{ms:.2f} ms {name[:60]}"
                                                         for ms, name in top))

    # ---- the main path: the default frame as one captured CUDA graph --------
    launches.update(frame_graph_phase(smi, pipe, cam, times, stage_ms["binning"]))

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
    frame_bf16(dev, smi, scene, cfg, knobs, pipe, ref, path[-1])
    frame_graph_path("use_tex_kernel=False", "textured", smi, planar, ppath[-1])
    free_pipeline(planar)
    frame_graph_path("all-plain", "textured", smi, ref, path[-1])
    free_pipeline(ref)
    del planar, ref
    torch.cuda.empty_cache()
    measured.update({"fused_cover": (0.0, ms_b, plain_ms_b, sum(cover_alone_ms)),
                     "resolve_shade": (err_c, ms_c, plain_ms_c, alone_c, cold_c),
                     "deferred_shade": (err_d, ms_d, plain_ms_d, alone_d, cold_d)})

    # ---- the planar texture-cache, cap-156 and anisotropic paths ------------
    launches_ptex = planar_tex_cells(dev, smi, scene, cfg, cam, knobs, pipe, cover_calls,
                                     measured, bounds)
    del pipe, scene, cover_calls, setup, bins, rows64, args
    torch.cuda.empty_cache()

    launches_l1k = lights1k(dev, smi, cam, knobs, base_knobs, measured, bounds)
    launches.update({k: launches_l1k[k] for k in ("env_resolve", "point_lights")})
    torch.cuda.empty_cache()
    launches.update(deferred_dtypes(dev, smi, cam, knobs, measured, bounds))
    torch.cuda.empty_cache()
    band_phases(smi)
    n_h_assets = asset_auto(dev, cam, smi)
    # H's launches: the depth-only stage call and the asset-auto census's
    launches.update(launches_ptex, raster_depth=n_h + n_h_assets)
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        app_cells(dev, smi, Path(tmp))
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
