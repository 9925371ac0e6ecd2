"""DeferredRenderPipeline — counterpart of `pipeline/deferred.py`.

The ten passes of `DeferredPipeline.{h,cpp}` (precompute, Cull, Clustered,
GBuffer, DeferredShading, Skybox, Bloom, AutoExposure, ToneMapping, Present)
declared against the render graph (`graph/frame_graph.py`, the port's copy
of the JAX package's), which orders them from their read/write sets. The
two precompute passes run once in the constructor and latch as device
tensors; every frame then runs the graph on `device`, with the
average-luminance EMA carried across frames.

On a CUDA device every path, whatever its knobs (`captured`), runs as one
captured CUDA graph a frame, the counterpart of the JAX pipeline's
`jax.jit(_frame)`: the first `render` captures `_frame` over static inputs
(`CapturedFrame`), every later one copies the packs that changed into them
and replays it, with no host sync when it collects no stats;
`render_sequence` replays it once a frame from camera packs uploaded
together (the JAX pipeline's `lax.scan`). A change to a knob the passes
read captures it anew. Any path on the CPU, and every frame inside an
`eager()` block (the counterpart of `jax.disable_jit()`), run the graph's
passes eagerly. `capture` is the capture itself, shared with the band
frame (`parallel/frame_sharded.py`).

Ported configurations (every path of the JAX pipeline but the knobs below):
* the default on a CUDA device (`use_pallas` and `use_tex_kernel` resolve to
  True there, False on the CPU, as the JAX package resolves them on an
  accelerator): the fused raster + interpolation kernel (kernel A,
  ops/raster_cuda.py) feeds the fused G-buffer (texture-cache plan with the
  page-cover kernel B, or the two-kernel cover I for caps above 128, then the
  resolve + pixel-shade kernel C) and the fused deferred pass (env-cache plan
  with kernel B, then kernel D), all on tile blocks;
* more than 64 active lights with `use_pallas` (the 1024-light operating
  point): `light_tile` is set, the fused deferred pass is off, and the
  unfused deferred pass runs the env taps through the float page cache
  (plan with kernel B, resolve with kernel F, ops/envcache.py) and the
  point lights per screen tile (kernel G, ops/lights_cuda.py), after the
  fused G-buffer (kernels A, B, C);
* the planar texture-cache G-buffer, where `use_tex_kernel` is on and the
  fused G-buffer's conditions fail (a raster tile not 128k wide or odd-high,
  `use_pallas=False`, or `texture_filter="anisotropic"`): kernel A's (H, W)
  planes (or, without use_pallas, the plain raster and the row gather) feed
  the texture cache on its own tiling (plan with kernel B or I, resolve with
  kernel E, ops/texcache.sample_atlas_tiled), or the anisotropic filter;
  the deferred pass is then the unfused one with the env cache (kernel F);
* `use_tex_kernel=False`: the direct-atlas G-buffer sampler (or the
  anisotropic filter) and the dense deferred shading with its serial light
  sweep (or kernel G with `light_tile`), with kernel A when `use_pallas`.
Without `use_pallas` the raster is the plain fold of
`stages.rasterize(use_pallas=False)`, as in the JAX pipeline. With
`tex_caps="auto"` and use_tex_kernel, the first `render` (or
`render_sequence`) runs the tap census (`tools/tap_census.run_census`) on
the scene at its pose and sizes `tex_caps` (caps, compact staging budget,
per-half block caps), `env_budget` and `tex_cascade` from it; the census's
raster is `stages.rasterize(use_pallas=...)`, on the card the depth-only
kernel H. `fused_light_dtype` ("float32", "bfloat16" or "float16") selects
kernel D's reduced-precision light loop on the fused deferred pass, as the
JAX package's knob selects its Pallas kernel's; the band frame
(`parallel/frame_sharded.py`) keeps the float32 loop, as the JAX band frame
does. On a CUDA device nothing quietly takes a plain path. The scene and
the camera are read by attribute only, so the JAX package's objects render
as well as the port's own.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import logging
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import (
    BRDF_LUT_SIZE,
    PREFILTER_ENVMAP_MIP_LEVELS,
    PREFILTER_ENVMAP_SIZE,
    RenderConfig,
)
from ..graph import frame_graph as fg
from ..ops import bloom as bloom_ops
from ..ops import (atlas_resolve_cuda, clustered, common, cover_cuda, env_resolve_cuda,
                   envcache, gbuffer, ibl, lights_cuda, postprocess, raster_cuda,
                   resolve_shade_cuda, shade_fused, texcache)
from ..scene.camera import Camera
from ..scene.scene import Scene
from ..tools import tap_census
from . import stages
from .scene_pack import PackedScene, pack_scene

_F32 = str(torch.float32)  # the graph compares str(dtype) with its declarations
CAPTURE_WARMUP = 2   # eager frames on the capture stream before a capture
# what the passes read from the pipeline when they run: a captured frame is
# keyed on them (with the config, the pack lengths and the device buffers)
_GRAPH_KNOBS = ("tex_caps", "env_budget", "tex_cascade", "fused_light_dtype", "texture_filter",
                "max_active_lights", "raster_caps", "bin_cap", "tile_h", "tile_w",
                "render_w", "render_h", "use_pallas", "use_tex_kernel", "use_fused_gbuffer",
                "use_fused_deferred", "light_tile", "light_cap", "env_ids", "env_tile")
_KERNEL_MODULES = (raster_cuda, cover_cuda, resolve_shade_cuda, shade_fused, atlas_resolve_cuda,
                   env_resolve_cuda, lights_cuda)
_EAGER = threading.local()   # `depth`: the thread's open `eager()` blocks


@contextlib.contextmanager
def eager():
    """While the block runs, every pipeline renders this thread's frames
    eagerly: the port's counterpart of `jax.disable_jit()` (thread-local,
    as JAX's is). A captured frame replays a CUDA graph and runs none of
    `_frame`'s Python, so a caller that intercepts kernel calls or times
    passes in Python runs inside this block."""
    _EAGER.depth = getattr(_EAGER, "depth", 0) + 1
    try:
        yield
    finally:
        _EAGER.depth -= 1


def _replays() -> bool:
    return not getattr(_EAGER, "depth", 0)


def _launch_counters() -> dict[tuple, int]:
    """{(module, wrapper, counter): count} of every kernel wrapper's launch
    counters (its `*launches` attributes)."""
    out = {}
    for mod in _KERNEL_MODULES:
        for name, fn in vars(mod).items():
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                out.update({(mod, name, attr): n for attr, n in vars(fn).items()
                            if attr.endswith("launches") and isinstance(n, int)})
    return out


def _add_launches(counts: dict[tuple, int]) -> None:
    for (mod, name, attr), n in counts.items():
        fn = getattr(mod, name)
        setattr(fn, attr, getattr(fn, attr) + n)


def _tensors(x):
    """Every tensor in a (nested) dict, tuple or buffer object."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif hasattr(x, "__dict__"):
        yield from _tensors(vars(x))


def _stats_vector(out) -> torch.Tensor:
    """`_frame`'s counters as one int32 vector: the bin counts, the visible
    instances and lights, the texture and env fallback taps and the light
    tile overflow (`DeferredRenderPipeline._stats_of` reads it)."""
    _, _, bin_counts, tex_approx, light_trunc, env_approx, vis_counts = out
    return torch.cat([x.reshape(-1).to(torch.int32) for x in
                      (bin_counts, vis_counts, tex_approx, env_approx, light_trunc)])


def _upload_into(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Copy `arr` into the device tensor `dst` from pinned host memory,
    without a host sync (the pinned block is not reused before the copy
    has run)."""
    dst.copy_(torch.from_numpy(arr).pin_memory(), non_blocking=True)


@dataclass
class CapturedGraph:
    """One call captured as a CUDA graph over static inputs (`capture`):
    `outputs` is what the call returned, in the graph's memory pool, which
    every replay overwrites."""
    graph: torch.cuda.CUDAGraph
    outputs: object
    launches: dict = field(repr=False)   # kernel launches a replay makes
    capture_s: float = 0.0               # host seconds of the capture
    pool_bytes: int = 0                  # device memory the capture reserved

    def replay(self) -> None:
        """Replay the graph on the current stream; each wrapper's launch
        counter gains the launches the capture recorded."""
        self.graph.replay()
        _add_launches(self.launches)


def capture(fn, stream: torch.cuda.Stream) -> CapturedGraph:
    """Capture `fn()`, a call over static inputs, into a CUDA graph on
    `stream`, after CAPTURE_WARMUP eager calls on that stream (they build
    the kernels, fill the persistent grids' caches, the raster's merge
    scratch of that stream, cuBLAS's workspace, the device constants and,
    for a call with NCCL collectives, the communicator). The capture is
    thread-local: other threads' CUDA calls go on. A capture launches
    nothing, so the wrappers' launch counts are left as they were before
    it; a failed capture raises."""
    dev = stream.device
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        for _ in range(CAPTURE_WARMUP):
            fn()
    torch.cuda.synchronize(dev)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    counts = _launch_counters()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            outputs = fn()
    finally:
        after = _launch_counters()
        for (mod, name, attr), n in counts.items():
            setattr(getattr(mod, name), attr, n)
    torch.cuda.synchronize(dev)
    return CapturedGraph(graph, outputs,
                         launches={k: n - counts.get(k, 0) for k, n in after.items()
                                   if n != counts.get(k, 0)},
                         capture_s=time.perf_counter() - t0,
                         pool_bytes=torch.cuda.memory_reserved(dev) - reserved)


@dataclass(kw_only=True)
class CapturedFrame(CapturedGraph):
    """One captured `_frame` (the counterpart of the JAX pipeline's
    `jax.jit(_frame)`): a CUDA graph over static inputs, the scene pack,
    the camera pack and the previous average luminance, whose outputs
    (`_frame`'s, and their `_stats_vector`) live in the graph's memory pool
    and are overwritten by every replay."""
    key: tuple
    scene: torch.Tensor
    camera: torch.Tensor
    prev_avg: torch.Tensor
    stats: torch.Tensor
    scene_np: np.ndarray | None = field(default=None, repr=False)
    camera_np: np.ndarray | None = field(default=None, repr=False)

    def load(self, scene_f32: np.ndarray, cam_f32: np.ndarray) -> None:
        """Copy the packs that changed into the static inputs."""
        if not np.array_equal(self.scene_np, scene_f32):
            _upload_into(self.scene, scene_f32)
            self.scene_np = scene_f32
        if not np.array_equal(self.camera_np, cam_f32):
            _upload_into(self.camera, cam_f32)
            self.camera_np = cam_f32


@dataclass
class FrameStats:
    visible_instances: int
    total_instances: int
    visible_lights: int
    bin_overflow: int = 0
    tex_approx_taps: int = 0  # cache-kernel taps resolved via fallback
    env_approx_taps: int = 0  # env-cache taps resolved via fallback/cascade
    lights_truncated: int = 0  # visible lights beyond max_active_lights
    light_tile_overflow: int = 0  # per-tile culled lights beyond light_cap


class DeferredRenderPipeline:
    def __init__(
        self,
        scene: Scene,
        config: RenderConfig | None = None,
        tile_h: int = 24,
        tile_w: int = 128,
        bin_cap: int = 2048,
        atlas_max_dim: int | None = 1024,
        prefilter_size: int | None = None,
        brdf_lut_size: int = BRDF_LUT_SIZE,
        use_pallas: bool | None = None,
        use_tex_kernel: bool | None = None,
        texture_filter: str = "trilinear",
        max_active_lights: int = 64,
        pallas_interpret: bool = False,
        light_tile: tuple | None = None,
        light_cap: int | None = None,
        tex_caps: tuple | str | None = None,
        env_budget: int | None = None,
        tex_cascade: bool = False,
        raster_caps: tuple | None = None,
        fused_light_dtype: str | None = None,
        *,
        device: torch.device | str,
    ):
        """Same knobs as the JAX pipeline, plus the explicit `device`.
        `use_pallas=None` and `use_tex_kernel=None` mean "on a CUDA device".
        The kernel path needs a bin_cap that is a multiple of
        raster_cuda.CHUNK: on a CUDA device any other bin_cap raises, on the
        CPU it turns use_pallas off as the JAX package does. `use_tex_kernel`
        takes the fused G-buffer with use_pallas, tile_w a multiple of 128,
        an even tile_h and trilinear or bilinear filtering, and the planar
        texture-cache G-buffer otherwise. The deferred pass is fused (kernel D)
        as in the JAX package: with at most 64 active lights, no
        `light_tile` and at most 4096 tile pixels; otherwise it is the
        unfused pass, with the env cache (kernel F) under use_tex_kernel and
        the tiled lights (kernel G) under `light_tile`, which is set
        automatically above 64 active lights with use_pallas.
        `fused_light_dtype`: None, "float32", "bfloat16" or "float16", the
        type of kernel D's light loop on the fused deferred pass (the JAX
        pipeline's knob; any other value raises ValueError); it has no
        effect on the unfused pass. `pallas_interpret` is accepted for
        signature parity with the JAX pipeline and has no effect (a CPU
        device takes each kernel's plain version)."""
        self.device = device = torch.device(device)
        self.config = config or RenderConfig()
        cfg = self.config
        # arbitrary resolutions: the raster canvas pads up to the tile grid
        # and the RT is cropped back before the post chain
        self.render_w = -(-cfg.width // tile_w) * tile_w
        self.render_h = -(-cfg.height // tile_h) * tile_h
        self.tile_h, self.tile_w, self.bin_cap = tile_h, tile_w, bin_cap
        self.max_active_lights = max_active_lights
        # content knobs, kept so that a reference pipeline can repeat them
        self.atlas_max_dim, self.prefilter_size = atlas_max_dim, prefilter_size
        self.brdf_lut_size = brdf_lut_size
        on_gpu = device.type == "cuda"
        if light_tile is None and max_active_lights > 64 and (
            use_pallas if use_pallas is not None else on_gpu
        ):
            light_tile = (tile_h, tile_w)
        self.light_tile = light_tile
        self.light_cap = light_cap if light_cap is not None else max(
            128, -(-min(max_active_lights, 1024) // 128) * 128)
        self.texture_filter = texture_filter
        shade_fused.check_light_dtype(fused_light_dtype)
        self.fused_light_dtype = fused_light_dtype
        # "auto": the first render runs the tap census on the actual scene at
        # the caller's first pose and sizes tex_caps, env_budget and the
        # cascade from it (_ensure_auto_caps)
        self._auto_caps = tex_caps == "auto"
        # texture/env cache budgets: used by the texture-cache path only
        self.tex_caps = None if self._auto_caps else tex_caps
        self.tex_cascade = tex_cascade
        self.env_budget = env_budget
        self.raster_caps = raster_caps
        if use_pallas is None:
            use_pallas = on_gpu
        use_pallas = bool(use_pallas)
        if use_pallas and bin_cap % raster_cuda.CHUNK:
            if on_gpu:
                # on the card the kernel path never gives way to the plain one
                raise ValueError(f"use_pallas needs a bin_cap that is a multiple of "
                                 f"{raster_cuda.CHUNK}, got {bin_cap} (or pass "
                                 "use_pallas=False)")
            use_pallas = False  # the JAX package's rule, kept for CPU parity
        self.use_pallas = use_pallas
        if use_tex_kernel is None:
            use_tex_kernel = on_gpu
        self.use_tex_kernel = (bool(use_tex_kernel)
                               and texcache.pick_tile(self.render_h, self.render_w) is not None)
        # the fused G-buffer needs the raster tile to be the cache tile
        # (128-pixel lane rows, even height for the 2x2 quads); anisotropic
        # filtering stays on the planar path (the multi-tap sampler)
        self.use_fused_gbuffer = (self.use_pallas and self.use_tex_kernel and tile_w % 128 == 0
                                  and tile_h % 2 == 0
                                  and texture_filter in ("trilinear", "bilinear"))
        # the fused deferred pass's light loop is serial over every active
        # light: it serves at most 64; more take the tiled lights (kernel G)
        self.use_fused_deferred = (self.use_fused_gbuffer and self.light_tile is None
                                   and max_active_lights <= 64
                                   and tile_h * tile_w <= 4096)

        self.scene = scene
        self.packed: PackedScene = pack_scene(scene, cfg, atlas_max_dim)
        if self.packed.config is not None:
            self.config = cfg = self.packed.config

        # ---- precompute passes (once, latched) ----------------------------
        self.brdf_lut = ibl.brdf_lut(size=brdf_lut_size, device=device)
        if scene.skybox is not None and scene.skybox.cubemap is not None:
            cube = scene.skybox.cubemap
            base = torch.as_tensor(
                np.stack([f.mip_array_rgba(0)[..., :3] for f in cube.faces]).astype(np.float32),
                device=device)
            src = ibl.build_cubemap_mips(base, int(np.log2(base.shape[1])) + 1)
            size = prefilter_size or min(PREFILTER_ENVMAP_SIZE, base.shape[1])
            pf = ibl.prefilter_env_map(src, out_size=size)
            sh_pack = np.asarray(cube.sh.as_array(), np.float32)
        else:
            size = prefilter_size or 64
            pf = [torch.zeros((6, size >> m, size >> m, 3), device=device)
                  for m in range(PREFILTER_ENVMAP_MIP_LEVELS)]
            base = torch.zeros((6, 8, 8, 3), device=device)
            sh_pack = np.zeros((7, 4), np.float32)
        self.sh_pack = sh_pack   # the JAX pipeline's name

        p = self.packed

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        self.buffers = {
            "positions": dev(p.positions),
            "normals": dev(p.normals),
            "tangents": dev(p.tangents),
            "uvs": dev(p.uvs),
            "vtx_instance": dev(p.vtx_instance),
            "tris": dev(p.tris),
            "tri_material": dev(p.tri_material),
            "tri_instance": dev(p.tri_instance),
            "tri_valid_pool": dev(p.tri_valid),
            "mat_rows": dev(gbuffer.pack_material_rows(
                p.materials.albedo, p.materials.emission, p.materials.roughness,
                p.materials.metallic, p.materials.use_map, p.materials.tex_ids)),
            "atlas": gbuffer.AtlasDevice.from_numpy(
                p.atlas.data, p.atlas.page_base, p.atlas.base_size, p.atlas.n_mips,
                p.atlas.srgb, device=device),
            "light_pos": dev(p.light_pos),
            "light_color": dev(p.light_color),
            "light_intensity": dev(p.light_intensity),
            "light_attenuation": dev(p.light_attenuation),
            "ClusterBounds": dev(clustered.cluster_bounds(cfg.fov, cfg.ratio, cfg.near,
                                                          cfg.far)),
            "SkyBoxSH": dev(sh_pack),
            "PrecomputeBRDF": (common.make_quad_tex2d(self.brdf_lut), self.brdf_lut.shape[0]),
            "PrefilterEnvMap": common.CubeMipAtlas.from_mips(pf, device),
            "SkyBoxTexture": common.CubeMipAtlas.from_mips([base], device),
        }
        # float page cache for the deferred taps (env cube trilinear halves,
        # BRDF LUT, skybox): the texture-cache path's env atlas, read by
        # kernel D (fused pass) or kernel F (unfused pass)
        self.env_ids = self.env_tile = None
        if self.use_tex_kernel:
            b = envcache.FloatAtlasBuilder()
            pf_np = [m.cpu().numpy() for m in pf]
            env_base = b.add_cube([[m[f] for m in pf_np] for f in range(6)])
            sky_np = base.cpu().numpy()
            sky_base = b.add_cube([[sky_np[f]] for f in range(6)])
            lut_tid = b.add([self.brdf_lut.cpu().numpy()])
            self.buffers["EnvCache"] = b.build(device)
            has_env = scene.skybox is not None and scene.skybox.cubemap is not None
            self.env_ids = (env_base, sky_base, lut_tid, len(pf_np), has_env)
            self.env_tile = texcache.pick_tile(self.render_h, self.render_w)
        self.graph = self._build_graph()
        self.avg_luminance = torch.zeros((), dtype=torch.float32, device=device)
        self.last_stats: FrameStats | None = None
        self._scene_np = self._scene_dev = None
        self._cam_np = self._cam_dev = None
        self.captured_frame: CapturedFrame | None = None   # the captured frame (`captured`)
        self._capture_stream = None

    def load_state(self, state: dict) -> None:
        """Replace the device buffers and the exposure carry with `state`
        (from state.state_from_jax): scene pools, material rows, atlas,
        lights and precompute products."""
        state = dict(state)
        avg = state.pop("avg_luminance")
        missing = set(self.buffers) - set(state)
        if missing:
            raise KeyError(f"state lacks buffers {sorted(missing)}")
        self.buffers = state
        self.avg_luminance = avg.to(self.device)

    # ------------------------------------------------------------------
    def _build_graph(self) -> fg.CompiledGraph:
        cfg = self.config
        w, h = cfg.width, cfg.height          # logical viewport
        rw, rh = self.render_w, self.render_h  # padded raster canvas

        def cull_pass(env):
            p = self.packed
            n_inst, n_lgt = p.instance_count, p.light_count
            vis = torch.zeros((p.model_mats.shape[0],), dtype=torch.bool, device=self.device)
            if n_inst:
                vis[:n_inst] = common.frustum_cull_aabbs(
                    env["FrustumPlanes"], env["InstanceBounds"][:n_inst, 0],
                    env["InstanceBounds"][:n_inst, 1])
            lv = torch.zeros((p.light_pos.shape[0],), dtype=torch.bool, device=self.device)
            if n_lgt:
                lv[:n_lgt] = common.frustum_cull_aabbs(
                    env["FrustumPlanes"], env["LightBounds"][:n_lgt, 0],
                    env["LightBounds"][:n_lgt, 1])
            counts = torch.stack([vis.sum(), lv.sum()]).to(torch.int32)
            return {"InstanceVisible": vis, "LightValid": lv, "VisibleCounts": counts}

        def clustered_pass(env):
            active = stages.active_lights(env, env["LightValid"], env["View"],
                                          self.max_active_lights)
            return {"FrustumCluster": (env["ClusterBounds"], active),
                    "PointLights": active[:, 13] > 0}

        def gbuffer_pass(env):
            setup, vattrs = stages.geometry(env, env["ModelMats"], env["NormalMats"],
                                            env["InstanceVisible"], env["ViewProj"], w, h)
            bins = stages.binning(setup, rw, rh, self.tile_h, self.tile_w, self.bin_cap)
            if self.use_fused_gbuffer:
                # kernel A's tile blocks feed the plan (kernel B) and the
                # resolve + pixel shade (kernel C); the deferred pass reads
                # the G-buffer tile blocks, the (H, W) planes are for parity
                tri_id, depth, pl_tiles, id_tiles, z_tiles = stages.rasterize_interp(
                    setup, bins, env, vattrs, rw, rh, self.tile_h, self.tile_w,
                    return_tiled=True, raster_caps=self.raster_caps, viewport=(w, h))
                out = gbuffer.gbuffer_shade_fused(
                    tri_id, depth, pl_tiles, id_tiles, env["atlas"], rh, rw, self.tile_h,
                    self.tile_w, self.texture_filter, tex_caps=self.tex_caps,
                    tex_cascade=self.tex_cascade, return_tiled=self.use_fused_deferred)
                result = {}
                if self.use_fused_deferred:
                    gb, gb_tiles = out
                    result["GBufferTiles"] = (gb_tiles, z_tiles, id_tiles)
                else:
                    gb = out
                return {
                    **result,
                    "GBufferA": gb.albedo_emission,
                    "GBufferB": gb.normal_oct,
                    "GBufferC": gb.rough_metal_ao,
                    "GBufferDepthStencil": (gb.depth, gb.mask),
                    "BinCounts": bins.counts,
                    "TexApproxCount": gb.tex_approx,
                }
            if self.use_pallas:
                # fused raster + attribute interpolation (kernel A): the
                # winning row is gathered once per pixel inside the kernel
                tri_id, depth, planes = stages.rasterize_interp(
                    setup, bins, env, vattrs, rw, rh, self.tile_h, self.tile_w,
                    raster_caps=self.raster_caps, viewport=(w, h))
                gb = gbuffer.gbuffer_shade_planar(
                    tri_id, depth, planes, env["atlas"], self.texture_filter,
                    use_tex_kernel=self.use_tex_kernel, tex_caps=self.tex_caps,
                    tex_cascade=self.tex_cascade)
            else:
                tri_id, depth = stages.rasterize(setup, bins, rw, rh, self.tile_h,
                                                 self.tile_w, self.use_pallas,
                                                 raster_caps=self.raster_caps,
                                                 viewport=(w, h))
                gb = stages.gbuffer_shade(
                    tri_id, depth, setup, env, vattrs, rw, rh,
                    texture_filter=self.texture_filter, use_tex_kernel=self.use_tex_kernel,
                    tex_caps=self.tex_caps, tex_cascade=self.tex_cascade)
            return {
                "GBufferA": gb.albedo_emission,
                "GBufferB": gb.normal_oct,
                "GBufferC": gb.rough_metal_ao,
                "GBufferDepthStencil": (gb.depth, gb.mask),
                "BinCounts": bins.counts,
                "TexApproxCount": (gb.tex_approx if gb.tex_approx is not None else
                                   torch.zeros((), dtype=torch.int32, device=self.device)),
            }

        def deferred_pass(env):
            depth, mask = env["GBufferDepthStencil"]
            _bounds, active = env["FrustumCluster"]
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            if self.use_fused_deferred:
                # env resolve + SH + split-sum + clustered lights + sky in
                # kernel D, on the G-buffer tile blocks
                gb_tiles, z_tiles, id_tiles = env["GBufferTiles"]
                rt, env_approx = stages.deferred_shade_fused(
                    gb_tiles, z_tiles, id_tiles, env, active, env["InvView"],
                    env["CameraPos"], cfg, rw, rh, self.tile_h, self.tile_w, self.env_ids,
                    full_height=h, full_width=w, env_budget=self.env_budget,
                    light_dtype=self.fused_light_dtype)
                if (rw, rh) != (w, h):
                    rt = rt[:h, :w].contiguous()
                return {"DeferredShadingRT": rt, "LightTruncCount": zero,
                        "EnvApproxCount": env_approx}
            gb = gbuffer.GBuffer(env["GBufferA"], env["GBufferB"], env["GBufferC"],
                                 depth, mask)
            rt, env_approx, light_counts = stages.deferred_shade(
                gb, env, active, env["InvView"], env["CameraPos"], cfg, rw, rh,
                full_height=h, full_width=w, env_ids=self.env_ids, env_tile=self.env_tile,
                env_budget=self.env_budget, return_env_approx=True,
                light_tile=self.light_tile, light_cap=self.light_cap,
                return_light_counts=True, light_count=self.packed.light_count)
            if (rw, rh) != (w, h):
                rt = rt[:h, :w].contiguous()  # crop the pad-to-tile canvas
            # per-tile culled-light counts beyond the cap: truncation
            trunc = (zero if light_counts is None
                     else torch.clamp(light_counts - self.light_cap, min=0).max())
            return {"DeferredShadingRT": rt, "LightTruncCount": trunc,
                    "EnvApproxCount": env_approx}

        def skybox_pass(env):
            # composited inside deferred_shade (sky where stencil == 0); the
            # pass exists for graph parity and re-publishes the RT
            return {"DeferredShadingRT": env["DeferredShadingRT"]}

        def bloom_pass(env):
            if not cfg.enable_bloom:
                return {"DeferredShadingRT": env["DeferredShadingRT"]}
            return {"DeferredShadingRT": bloom_ops.bloom(env["DeferredShadingRT"])}

        def auto_exposure_pass(env):
            hist = postprocess.luminance_histogram(env["DeferredShadingRT"])
            if cfg.enable_auto_exposure:
                avg = postprocess.average_luminance_direct(
                    env["DeferredShadingRT"], float(w * h), env["PrevAverageLuminance"],
                    env["DeltaTime"])
            else:
                avg = torch.full((), 0.18, dtype=torch.float32, device=self.device)
            return {"LuminanceHistogram": hist, "AverageLuminance": avg}

        def tone_mapping_pass(env):
            return {"ToneMappedTexture": postprocess.tone_map(env["DeferredShadingRT"],
                                                              env["AverageLuminance"])}

        def present_pass(env):
            rgb8 = (env["ToneMappedTexture"] * 255.0 + 0.5).to(torch.uint8)
            return {"BackBuffer": (rgb8, env["AverageLuminance"], env["BinCounts"],
                                   env["TexApproxCount"], env["LightTruncCount"],
                                   env["EnvApproxCount"], env["VisibleCounts"])}

        gdesc = {
            "GBufferA": fg.ResourceDesc((rh, rw, 4), _F32),
            "GBufferB": fg.ResourceDesc((rh, rw, 2), _F32),
            "GBufferC": fg.ResourceDesc((rh, rw, 3), _F32),
        }
        rt_desc = {"DeferredShadingRT": fg.ResourceDesc((h, w, 3), _F32)}
        tiles = ("GBufferTiles",) if self.use_fused_deferred else ()
        passes = [
            fg.RenderPass("Cull", ("FrustumPlanes", "InstanceBounds", "LightBounds"),
                          ("InstanceVisible", "LightValid", "VisibleCounts"), cull_pass),
            fg.RenderPass("Clustered",
                          ("ClusterBounds", "View", "light_pos", "light_attenuation",
                           "light_intensity", "LightValid"),
                          ("FrustumCluster", "PointLights"), clustered_pass),
            fg.RenderPass("GBuffer",
                          ("positions", "normals", "tangents", "uvs", "vtx_instance",
                           "tris", "tri_material", "tri_instance", "tri_valid_pool",
                           "mat_rows", "atlas", "ModelMats", "NormalMats", "ViewProj",
                           "InstanceVisible"),
                          ("GBufferA", "GBufferB", "GBufferC", "GBufferDepthStencil",
                           "BinCounts", "TexApproxCount") + tiles,
                          gbuffer_pass, declares=gdesc),
            fg.RenderPass("DeferredShading",
                          ("GBufferA", "GBufferB", "GBufferC", "GBufferDepthStencil",
                           "SkyBoxSH", "PrecomputeBRDF", "PrefilterEnvMap", "SkyBoxTexture",
                           "FrustumCluster", "InvView", "CameraPos")
                          + (("EnvCache",) if self.env_ids is not None else ()) + tiles,
                          ("DeferredShadingRT", "LightTruncCount", "EnvApproxCount"),
                          deferred_pass, declares={**gdesc, **rt_desc}),
            fg.RenderPass("Skybox", (), ("DeferredShadingRT",), skybox_pass),
            fg.RenderPass("Bloom", ("DeferredShadingRT",), ("DeferredShadingRT",),
                          bloom_pass, declares=rt_desc),
            fg.RenderPass("AutoExposure",
                          ("DeferredShadingRT", "PrevAverageLuminance", "DeltaTime"),
                          ("LuminanceHistogram", "AverageLuminance"), auto_exposure_pass),
            fg.RenderPass("ToneMapping", ("DeferredShadingRT", "AverageLuminance"),
                          ("ToneMappedTexture",), tone_mapping_pass,
                          declares={"ToneMappedTexture": fg.ResourceDesc((h, w, 3), _F32)}),
            fg.RenderPass("Present",
                          ("ToneMappedTexture", "AverageLuminance", "BinCounts",
                           "TexApproxCount", "LightTruncCount", "EnvApproxCount",
                           "VisibleCounts"),
                          ("BackBuffer",), present_pass),
        ]
        return fg.compile_graph(passes, present="Present")

    # ------------------------------------------------------------------
    def _frame(self, scene_f32, cam_f32, prev_avg_lum):
        p = self.packed
        i = p.model_mats.shape[0]
        mm = scene_f32[: i * 16].reshape(i, 4, 4)
        off = i * 16
        nm = scene_f32[off: off + i * 9].reshape(i, 3, 3)
        off += i * 9
        nb = p.instance_bounds.shape[0]
        ib = scene_f32[off: off + nb * 6].reshape(nb, 2, 3)
        off += nb * 6
        lbn = p.light_bounds.shape[0]
        lb = scene_f32[off: off + lbn * 6].reshape(lbn, 2, 3)
        env = dict(self.buffers)
        env.update(
            ModelMats=mm, NormalMats=nm, InstanceBounds=ib, LightBounds=lb,
            FrustumPlanes=cam_f32[:24].reshape(6, 4),
            View=cam_f32[24:40].reshape(4, 4),
            InvView=cam_f32[40:56].reshape(4, 4),
            ViewProj=cam_f32[56:72].reshape(4, 4),
            CameraPos=cam_f32[72:75],
            PrevAverageLuminance=prev_avg_lum,
            DeltaTime=cam_f32[75],
        )
        return fg.execute(self.graph, env)["BackBuffer"]

    def _pack_camera(self, camera: Camera, delta_time: float) -> np.ndarray:
        view = camera.view_matrix()
        return np.concatenate([
            np.asarray(camera.frustum_planes(), np.float32).ravel(),
            np.asarray(view, np.float32).ravel(),
            np.asarray(camera.world_matrix(), np.float32).ravel(),
            np.asarray(camera.projection_matrix() @ view, np.float32).ravel(),
            np.asarray(camera.position, np.float32).ravel(),
            np.float32([delta_time]),
        ]).astype(np.float32)

    def _pack_scene(self) -> np.ndarray:
        p = self.packed
        normal_mats = np.ascontiguousarray(np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1)))
        return np.concatenate([
            p.model_mats.ravel(), normal_mats.ravel(),
            p.instance_bounds.ravel(), p.light_bounds.ravel(),
        ]).astype(np.float32)

    def _upload(self, camera: Camera, delta_time: float):
        # scene and camera packs are re-uploaded only when they change
        scene_f32 = self._pack_scene()
        if self._scene_np is None or not np.array_equal(self._scene_np, scene_f32):
            self._scene_np = scene_f32
            self._scene_dev = torch.as_tensor(scene_f32, device=self.device)
        cam_f32 = self._pack_camera(camera, delta_time)
        if self._cam_np is None or not np.array_equal(self._cam_np, cam_f32):
            self._cam_np = cam_f32
            self._cam_dev = torch.as_tensor(cam_f32, device=self.device)

    def _ensure_auto_caps(self, camera: Camera):
        """tex_caps="auto": size every cache budget from a census of the
        actual scene at the caller's first pose (tools/tap_census over three
        poses of a 30 degree yaw sweep). After that the pipeline is one
        constructed with the measured knobs. The graph is not rebuilt: its
        passes read tex_caps, env_budget and tex_cascade from the pipeline
        when they run, not when they are built."""
        if not self._auto_caps:
            return
        self._auto_caps = False
        if not self.use_tex_kernel:
            return  # the direct-atlas samplers have no budgets to size
        censuses, caps, env_censuses = tap_census.run_census(
            # run_census rotates the camera along the sweep: probe a copy
            self, copy.deepcopy(camera), poses=3, yaw_sweep_deg=30.0)
        block_caps = texcache.recommend_block_caps(censuses)
        budget = texcache.recommend_budget(censuses)
        self.tex_caps = (caps[0], caps[1], budget, block_caps)
        if env_censuses:
            self.env_budget = envcache.recommend_budget(env_censuses)
        if self.tex_cascade is False:
            # outlier rows beyond the sized block caps resolve at near
            # trilinear through the mip+1 cascade, not the coarsest mip
            self.tex_cascade = (12, 8, 1)
        logging.getLogger(__name__).info(
            "auto tex caps: cap=(%d,%d) block_cap=%s stage_budget=%d env_budget=%s",
            caps[0], caps[1], block_caps, budget, self.env_budget)

    @property
    def captured(self) -> bool:
        """Whether `render` and `render_sequence` replay a captured frame
        (`CapturedFrame`) outside an `eager()` block: on a CUDA device,
        whatever the knobs; on the CPU every path renders eagerly."""
        return self.device.type == "cuda"

    def _graph_key(self) -> tuple:
        """What a captured frame depends on besides its static inputs: the
        knobs the passes read when they run, the config, the graph, the pack
        lengths and the device buffers' addresses."""
        p = self.packed
        return (tuple(repr(getattr(self, k)) for k in _GRAPH_KNOBS), repr(self.config),
                id(self.graph), p.model_mats.shape, p.instance_bounds.shape,
                p.light_bounds.shape, p.instance_count, p.light_count,
                tuple(t.data_ptr() for t in _tensors(self.buffers)))

    def _captured_frame(self, scene_f32: np.ndarray, cam_f32: np.ndarray) -> CapturedFrame:
        """The captured frame for the pipeline's current knobs with the packs
        loaded; captured anew whenever its key changed."""
        key = self._graph_key()
        if self.captured_frame is not None and self.captured_frame.key == key:
            self.captured_frame.load(scene_f32, cam_f32)
        else:
            self.captured_frame = None   # the old graph's pool goes first
            self.captured_frame = self._capture(key, scene_f32, cam_f32)
        return self.captured_frame

    def _capture(self, key: tuple, scene_f32: np.ndarray, cam_f32: np.ndarray) -> CapturedFrame:
        """Capture `_frame` (`capture`) over static inputs holding these
        packs and the exposure carry."""
        dev = self.device
        scene = torch.as_tensor(scene_f32, device=dev)
        camera = torch.as_tensor(cam_f32, device=dev)
        prev_avg = self.avg_luminance.clone()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)

        def frame():
            out = self._frame(scene, camera, prev_avg)
            return out, _stats_vector(out)

        cap = capture(frame, self._capture_stream)
        outputs, stats = cap.outputs
        return CapturedFrame(**dict(vars(cap), outputs=outputs), key=key, scene=scene,
                             camera=camera, prev_avg=prev_avg, stats=stats,
                             scene_np=scene_f32, camera_np=cam_f32)

    def render_sequence(self, cameras, delta_time: float = 1.0 / 60.0):
        """Render a camera path with the exposure EMA carried frame to frame,
        as N `render` calls would. Returns the stacked (N, H, W, 3) uint8
        frames. Where the frame is captured (`captured`), the N camera packs
        go to the device in one copy and each frame is a device copy of its
        pack into the static input, a replay and a copy of the frame, with
        the EMA chained on the device: no host sync from the first replay to
        the return (the counterpart of the JAX pipeline's `lax.scan`).
        Otherwise it is a loop of `render` calls."""
        if cameras:
            self._ensure_auto_caps(cameras[0])
        if not (cameras and self.captured and _replays()):
            return torch.stack([self.render(c, delta_time, collect_stats=False)
                                for c in cameras])
        packs = np.stack([self._pack_camera(c, delta_time) for c in cameras])
        cf = self._captured_frame(self._pack_scene(), packs[0])
        cams = torch.from_numpy(packs).pin_memory().to(self.device, non_blocking=True)
        rgb8, avg = cf.outputs[:2]
        frames = torch.empty((len(cameras), *rgb8.shape), dtype=rgb8.dtype, device=self.device)
        cf.prev_avg.copy_(self.avg_luminance)
        for i in range(len(cameras)):
            cf.camera.copy_(cams[i])
            cf.replay()
            frames[i].copy_(rgb8)
            cf.prev_avg.copy_(avg)
        cf.camera_np = packs[-1]
        self.avg_luminance = avg.clone()
        return frames

    def render(self, camera: Camera, delta_time: float = 1.0 / 60.0,
               collect_stats: bool = True):
        """One frame -> (H, W, 3) uint8 tensor on the pipeline's device.

        Where the frame is captured (`captured`, outside `eager()`): the
        packs that changed are copied into the graph's static inputs from
        pinned memory, the graph replays, and the frame and the exposure
        carry come back as clones; the first call (and the first after a
        knob it reads changed) captures it. collect_stats=False makes that a
        frame with no host sync; collect_stats=True reads the counters back
        in one device-to-host copy."""
        self._ensure_auto_caps(camera)
        if self.captured and _replays():
            cf = self._captured_frame(self._pack_scene(), self._pack_camera(camera, delta_time))
            cf.prev_avg.copy_(self.avg_luminance)
            cf.replay()
            rgb8, avg = (x.clone() for x in cf.outputs[:2])
            stats = cf.stats
        else:
            self._upload(camera, delta_time)
            out = self._frame(self._scene_dev, self._cam_dev, self.avg_luminance)
            rgb8, avg = out[:2]
            stats = _stats_vector(out) if collect_stats else None
        self.avg_luminance = avg
        if collect_stats:
            self.last_stats = self._stats_of(stats.cpu().numpy())
        return rgb8

    def _stats_of(self, vec: np.ndarray) -> FrameStats:
        """FrameStats from a frame's `_stats_vector`."""
        n = vec.size - 5
        tex_approx, env_approx, light_trunc = (int(x) for x in vec[n + 2:])
        return self._stats(vec[:n], vec[n:n + 2], tex_approx, env_approx, light_trunc)

    def _stats(self, counts_np, vis_np, tex_approx, env_approx, light_trunc) -> FrameStats:
        overflow = int(np.maximum(counts_np - self.bin_cap, 0).max())
        if self.use_pallas:
            # two-pass raster: tiles beyond the hot set that exceed the small
            # cap also lose triangles — surface them the same way
            if self.raster_caps is not None:
                cap_small, hot_k = self.raster_caps
                hot_k = min(hot_k, counts_np.size)
            else:
                cap_small, hot_k = raster_cuda.split_caps(self.bin_cap, counts_np.size)
            n_over_small = int((counts_np > cap_small).sum())
            if n_over_small > hot_k:
                over = np.sort(counts_np[counts_np > cap_small])
                overflow = max(
                    overflow,
                    int(np.maximum(over[:-hot_k] - cap_small, 0).max())
                    if hot_k else int((over - cap_small).max()),
                )
        n_vis_lights = int(vis_np[1])
        stats = FrameStats(
            visible_instances=int(vis_np[0]),
            total_instances=self.packed.instance_count,
            visible_lights=n_vis_lights,
            bin_overflow=overflow,
            tex_approx_taps=tex_approx,
            env_approx_taps=env_approx,
            lights_truncated=max(0, n_vis_lights - self.max_active_lights),
            light_tile_overflow=light_trunc,
        )
        if stats.lights_truncated:
            logging.getLogger(__name__).warning(
                "%d visible lights exceed max_active_lights=%d; excess lights are "
                "dropped (raise max_active_lights)", n_vis_lights, self.max_active_lights)
        return stats
