"""Multi-GPU frame rendering: the framebuffer in row bands over
torch.distributed — counterpart of `parallel/frame_sharded.py`.

The JAX package splits the frame into row bands over a 1D device mesh: each
device culls, transforms and sets up the whole scene (cheap, replicated),
bins the triangles against its own rows, and rasterizes, G-buffer-shades and
deferred-shades its band; bloom, auto-exposure and tone mapping then run
across the bands. Here the mesh is a process group with one band per rank
(`make_mesh`), and the post chain is the JAX semantics laid out on the group
with `all_reduce` only:

* bloom (`ops/bloom.bloom_band`): levels with at least 16 rows per rank are
  row-parallel, each rank multiplying its rows of the level's matrix by the
  whole previous level, gathered as a sum of zero-filled levels (exact);
  smaller levels are computed whole on every rank;
* exposure: each band's integer sums (`postprocess.luminance_sums`) add up
  to the frame's, so the EMA equals the single-device value bit for bit on
  equal HDR input;
* tone mapping and quantization per band.

`build_sharded_frame(mesh, pipe)` reads every knob off the pipeline it
shards and calls the same `pipeline.stages` entry points, so the band frame
runs the kernels of the pipeline's path (on the card: A, B, C, D by default;
A, B, C, F, G with more than 64 lights) at the band's offset. Each rank
builds its own pipeline from the same scene: scene buffers and lights are
replicated. The collectives run on the rank's device tensors; with the gloo
backend on CUDA tensors the copies to host memory are gloo's own.

Traced (`pipe.start_trace()` on every rank's pipeline), a band frame
records the single-card frame's stages where it has them (Cull, GBuffer
with its gbuffer.* stages, Clustered, DeferredShading, Bloom,
AutoExposure, ToneMapping, stats) and a "band.exchange" span around every
collective of `BandMesh.all_reduce`: bloom's, the exposure's, the
counters', and `gather_rows`' after the frame, whose marks land in the
frame's row.

On a card the band frame is captured, the counterpart of the JAX band
frame's `jax.jit(frame)` (`BandFrame`): its first call outside
`deferred.eager()` captures a CUDA graph over static inputs and every later
call copies its small arguments in and replays it. On NCCL ranks the graph
holds the whole frame, the collectives included. Gloo copies CUDA tensors
through host memory, which no graph can hold, so on gloo ranks the graph
holds the band body (`band_render`: everything before the first collective)
and the post chain runs eagerly on its outputs. On the CPU, and inside
`eager()`, the frame runs eagerly.

Start the ranks with `torchrun --nproc-per-node N` (one card each, NCCL), or
with `launch`, which spawns them on a `FileStore` in a temporary directory.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import bloom as bloom_ops
from ..ops import common, postprocess, texcache
from ..pipeline import stages
from ..pipeline.deferred import CapturedGraph, _replays, _tensors, capture
from ..utils import trace


@dataclass
class BandMesh:
    """The ranks one frame's row bands are spread over, one band a rank:
    the process group, this rank's index in it, its size, and the device
    its band renders on."""
    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce `t` in place over the group; returns it. Traced, it is a
        "band.exchange" span (on captured frames too)."""
        with trace.span("band.exchange"):
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def gather(self, part: torch.Tensor, n_rows: int, lo: int) -> torch.Tensor:
        """The whole (n_rows, ...) tensor whose rows [lo, lo + len(part)) this
        rank holds: the group's sum of zero-filled tensors (exact)."""
        full = part.new_zeros((n_rows,) + tuple(part.shape[1:]))
        full[lo:lo + part.shape[0]] = part
        return self.all_reduce(full)


def make_mesh(n_devices: int | None = None, *, device=None) -> BandMesh | None:
    """The mesh of the first `n_devices` ranks of the default process group
    (the whole world with None), which the caller has initialized (torchrun,
    or `launch`). Every rank of the world must call it: a smaller mesh is a
    new subgroup, and a rank outside it gets None. `device=None` means this
    rank's card, cuda:(rank % device count), and raises without one; the CPU
    renders only when the caller asks for it (`device="cpu"`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: start the ranks "
                           "with torchrun or frame_sharded.launch")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the band: pass device='cpu' to render "
                               "the bands on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return BandMesh(group, rank, n, device)


def frame_args(pipe, camera, prev_avg_lum=0.0, delta_time: float = 1.0 / 60.0):
    """The band frame's twelve arguments for `camera`, on the pipeline's
    device, as the pipeline's own frame packs them (float32). On a card the
    packs go up from pinned memory without a host sync. `prev_avg_lum`, the
    exposure carry, is a float or a tensor: pass the previous band frame's
    `avg` to carry it on the device with no host read."""
    p = pipe.packed
    view = camera.view_matrix()

    def dev(a):
        t = torch.from_numpy(np.array(a, np.float32))
        if pipe.device.type == "cuda":
            t = t.pin_memory()
        return t.to(pipe.device, non_blocking=True)

    prev = (prev_avg_lum.to(pipe.device, torch.float32) if isinstance(prev_avg_lum, torch.Tensor)
            else dev(prev_avg_lum))
    normal_mats = np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1))
    return (pipe.buffers, dev(p.model_mats), dev(normal_mats), dev(p.instance_bounds),
            dev(p.light_bounds), dev(camera.frustum_planes()), dev(view),
            dev(camera.world_matrix()), dev(camera.projection_matrix() @ view),
            dev(camera.position), prev, dev(delta_time))


class BandFrame:
    """frame(...) of `build_sharded_frame`: one band frame a call, captured
    on a card (the counterpart of the JAX band frame's `jax.jit(frame)`).

    On a CUDA mesh, the first call outside `deferred.eager()` captures
    (`deferred.capture`: CAPTURE_WARMUP eager calls on a side stream, then
    the capture) over static copies of the eleven small arguments, and
    every call copies them in on the device, with no host sync, and
    replays the graph. On NCCL ranks the graph is the whole frame; on gloo
    ranks it is `band_render`, and the post chain (bloom, exposure, tone
    mapping, the stats' collectives) runs eagerly on its outputs. The
    outputs are clones, as `render` returns them. `captured` is the
    capture (`capture_s`, `pool_bytes`, the launches a replay adds).

    The graph is keyed on the pipeline's `_graph_key()`, the mesh (rank,
    size, backend), `collect_stats`, the addresses of `buffers` and the
    arguments' shapes: a change captures it anew. Every rank must make the
    same changes at the same call: the capture's warm-up frames run the
    NCCL collectives, so a rank that captures alone deadlocks the group.
    Tracing joins the key (`pipe._graph_key()`): turn it on or off on every
    rank at the same call.

    On the CPU, and inside `eager()`, every call runs the frame eagerly."""

    def __init__(self, mesh: BandMesh, pipe, collect_stats: bool, band_render, post):
        self.mesh, self.pipe, self.collect_stats = mesh, pipe, collect_stats
        self.band_render, self.post = band_render, post
        self.captured: CapturedGraph | None = None
        self._key = None
        self._static: tuple = ()
        self._stream = None

    def run_eager(self, buffers, *small):
        """The frame run eagerly: the band body, then the post chain."""
        return self.post(*self.band_render(buffers, *small[:9]), *small[9:])

    def __call__(self, buffers, *small):
        mesh = self.mesh
        if mesh.device.type != "cuda" or not _replays():
            return self.run_eager(buffers, *small)
        backend = dist.get_backend(mesh.group)
        whole = backend == "nccl"
        key = (self.pipe._graph_key(), mesh.rank, mesh.size, backend, self.collect_stats,
               tuple(t.data_ptr() for t in _tensors(buffers)),
               tuple((a.shape, a.dtype, a.device) for a in small))
        if key != self._key:
            self.captured = self._key = None   # the old graph's pool goes first
            static = self._static = tuple(a.clone() for a in small)
            if self._stream is None:
                self._stream = torch.cuda.Stream(mesh.device)
            if whole:
                self.captured = capture(lambda: self.run_eager(buffers, *static), self._stream)
            else:
                self.captured = capture(lambda: self.band_render(buffers, *static[:9]),
                                        self._stream)
            self._key = key
        for dst, src in zip(self._static, small):
            dst.copy_(src)
        self.captured.replay()
        out = (self.captured.outputs if whole
               else self.post(*self.captured.outputs, *small[9:]))
        return tuple(x.clone() for x in out)


def build_sharded_frame(mesh: BandMesh, pipe, collect_stats: bool = False) -> BandFrame:
    """frame(...) rendering `pipe`'s scene in row bands over `mesh`, with
    the same kernels and knobs as `pipe`'s single-device graph; captured on
    a card (`BandFrame`).

    frame(buffers, model_mats, normal_mats, instance_bounds, light_bounds,
          frustum_planes, view, inv_view, view_proj, camera_pos,
          prev_avg_lum, delta_time)
      -> (band_rgb8 (H / n, W, 3) uint8, this rank's rows; avg_luminance)
      [+ (bin_counts, every band's tiles in band order; tex_approx and
         env_approx, summed over the bands; light_trunc, their maximum)
       with collect_stats]

    The arguments are tensors on the rank's device (`frame_args`); pass
    each frame's `avg` on as the next frame's `prev_avg_lum`. The
    height must split into n equal bands; each band's canvas rounds up to
    whole tiles and is cropped back, so 1080 rows on 4 ranks are 270-row
    bands on 288-row canvases. Every raster call gets the viewport (W, H):
    the last band's padded rows lie below it. `tex_caps="auto"` is read as
    it stands: this frame runs no census, so before the pipeline's first
    `render` its caps are None."""
    n = mesh.size
    cfg = pipe.config
    w, h = cfg.width, cfg.height
    tile_h, tile_w, bin_cap = pipe.tile_h, pipe.tile_w, pipe.bin_cap
    if h % n:
        raise ValueError(f"height {h} must split into {n} equal bands")
    band_h = h // n
    band_rh = -(-band_h // tile_h) * tile_h   # the band's pad-to-tile canvas
    rw = -(-w // tile_w) * tile_w
    band_tile = texcache.pick_tile(band_rh, rw)
    use_tex_kernel = pipe.use_tex_kernel and band_tile is not None
    use_fused = (pipe.use_fused_gbuffer and use_tex_kernel and tile_w % 128 == 0
                 and tile_h % 2 == 0)
    env_ids = pipe.env_ids if band_tile is not None else None
    # the fused deferred pass follows the pipeline's own gate (<= 64 lights,
    # no light tile), band-gated on the env cache like the rest
    use_fused_deferred = use_fused and pipe.use_fused_deferred and env_ids is not None
    y0 = mesh.rank * band_h
    viewport = (w, h)

    def band_render(buffers, model_mats, normal_mats, instance_bounds, light_bounds,
                    frustum_planes, view, inv_view, view_proj, camera_pos):
        # the Cull pass on the device; the pool's padding rows (zero AABBs
        # at the origin) are masked off by index
        trace.begin_frame(pipe.tracer)
        trace.stage("Cull", 1)
        dev = instance_bounds.device
        n_inst, n_lgt = pipe.packed.instance_count, pipe.packed.light_count
        instance_visible = common.frustum_cull_aabbs(
            frustum_planes, instance_bounds[:, 0], instance_bounds[:, 1]
        ) & (torch.arange(instance_bounds.shape[0], device=dev) < n_inst)
        light_valid = common.frustum_cull_aabbs(
            frustum_planes, light_bounds[:, 0], light_bounds[:, 1]
        ) & (torch.arange(light_bounds.shape[0], device=dev) < n_lgt)

        trace.stage("GBuffer", 1)
        gb, bins, tiles = stages.gbuffer_pass(
            buffers, model_mats, normal_mats, instance_visible, view_proj, w, h, rw, band_rh,
            tile_h, tile_w, bin_cap, use_pallas=pipe.use_pallas, use_fused=use_fused,
            use_tex_kernel=use_tex_kernel, texture_filter=pipe.texture_filter,
            tex_caps=pipe.tex_caps, tex_cascade=pipe.tex_cascade, raster_caps=pipe.raster_caps,
            return_tiled=use_fused_deferred, y_offset=y0)
        trace.stage("Clustered", 1)
        active = stages.active_lights(buffers, light_valid, view, pipe.max_active_lights)
        trace.stage("DeferredShading", 1)
        light_counts = None
        if use_fused_deferred:
            # kernel D: the pixel coordinates ride y_offset / full_height. Its
            # light loop stays float32 whatever pipe.fused_light_dtype says:
            # the JAX band frame does not pass its light_dtype either
            gb_tiles, z_tiles, id_tiles = tiles
            rt, env_approx = stages.deferred_shade_fused(
                gb_tiles, z_tiles, id_tiles, buffers, active, inv_view, camera_pos, cfg, rw,
                band_rh, tile_h, tile_w, env_ids, y_offset=y0, full_height=h, full_width=w,
                env_budget=pipe.env_budget)
        else:
            # with a light tile the counts are those of the pass's own
            # lights_cuda.tile_light_lists(..., y_offset=y0) call
            rt, env_approx, light_counts = stages.deferred_shade(
                gb, buffers, active, inv_view, camera_pos, cfg, rw, band_rh, y_offset=y0,
                full_height=h, full_width=w, env_ids=env_ids,
                env_tile=band_tile if env_ids is not None else None,
                env_budget=pipe.env_budget, return_env_approx=True,
                light_tile=pipe.light_tile, light_cap=pipe.light_cap,
                return_light_counts=True, light_count=pipe.packed.light_count)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        tex_approx = gb.tex_approx if gb.tex_approx is not None else zero
        trunc = (zero if light_counts is None
                 else torch.clamp(light_counts - pipe.light_cap, min=0).max())
        return rt[:band_h, :w], (bins.counts, tex_approx, env_approx, trunc)

    def post(rt, stats, prev_avg_lum, delta_time):
        counts, tex_approx, env_approx, trunc = stats
        trace.stage("Bloom", 1)
        if cfg.enable_bloom:
            rt = bloom_ops.bloom_band(rt, h, mesh)
        trace.stage("AutoExposure", 1)
        sums = mesh.all_reduce(postprocess.luminance_sums(rt))
        avg = postprocess.average_luminance_from_sums(sums, float(w * h), prev_avg_lum,
                                                      delta_time)
        trace.stage("ToneMapping", 1)
        rgb8 = (postprocess.tone_map(rt, avg) * 255.0 + 0.5).to(torch.uint8)
        if not collect_stats:
            trace.finish_frame()
            return rgb8, avg
        trace.stage("stats", 1)
        bin_counts = mesh.gather(counts, n * counts.shape[0], mesh.rank * counts.shape[0])
        approx = mesh.all_reduce(torch.stack([tex_approx, env_approx]).to(torch.int32))
        trunc = mesh.all_reduce(trunc.to(torch.int32).reshape(1), op=dist.ReduceOp.MAX)[0]
        trace.finish_frame()
        return rgb8, avg, bin_counts, approx[0], trunc, approx[1]

    return BandFrame(mesh, pipe, collect_stats, band_render, post)


def gather_rows(mesh: BandMesh, band: torch.Tensor) -> torch.Tensor:
    """The whole (H, W, 3) frame on every rank from each rank's band."""
    return mesh.gather(band, mesh.size * band.shape[0], mesh.rank * band.shape[0])


def backend_for(n: int, device) -> str:
    """NCCL when every rank has a card of its own (`device="cuda"` and at
    most one rank per card); gloo when the ranks share one device (NCCL
    refuses two ranks on one GPU) or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def launch(n: int, fn, *args, device="cuda") -> list:
    """Run fn(mesh, *args) on n spawned ranks of one process group and
    return their results in rank order. `device`: "cuda" (rank r on card
    r % device count), "cuda:K" (every rank on card K) or "cpu"; the backend
    is `backend_for(n, device)`. The ranks meet on a FileStore in a
    temporary directory (no port). `fn` and `args` are pickled to a file
    there, which each rank reads (a spawned process's arguments pass
    through a pipe that the parent fills only as fast as each child starts,
    so large ones would start the ranks one after another), and so is each
    result (return CPU tensors or numpy arrays). A rank that raises fails
    the call: the others are stopped and its error is raised here."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        mp.start_processes(_rank_main, args=(n, backend_for(n, device), str(device), tmp),
                           nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def _rank_main(rank: int, n: int, backend: str, device: str, tmp: str) -> None:
    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        mesh = make_mesh(device=None if device == "cuda" else device)
        torch.save(fn(mesh, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
