"""Per-band render stages — counterpart of `pipeline/stages.py`.

One implementation of the heavy frame stages, shared by the pipeline (a
full frame is one band at y_offset 0) and by the band frame
(`parallel/frame_sharded.py`). `cull`, `gbuffer_pass` and `deferred_shading`
are the Cull, GBuffer and DeferredShading passes of both, on the path a
`Route` names (`DeferredRenderPipeline.route`). `gbuffer_pass` marks its
stages for the tracer (`utils/trace.py`): gbuffer.geometry,
gbuffer.binning, gbuffer.raster, gbuffer.tex_plan (the taps' setup and the
texture plan) and gbuffer.tex_resolve (from the end of the plan, which
`ops/texcache.py` marks, or where `ops/gbuffer.py` starts a sampler that
needs no plan).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import clustered, common, gbuffer, raster, raster_cuda, shade_fused, shading
from ..utils import trace


@dataclass(frozen=True)
class Route:
    """The path of a frame on one canvas (`DeferredRenderPipeline.route`):
    the texture and env caches where `use_tex_kernel` (`env_tile`, the
    canvas's cache tiling, and `env_ids`, the env atlas's ids, are None
    otherwise), the fused G-buffer and the fused deferred pass."""
    use_tex_kernel: bool
    use_fused_gbuffer: bool
    use_fused_deferred: bool
    env_ids: tuple | None
    env_tile: tuple | None


def cull(frustum_planes, instance_bounds, light_bounds, n_instances: int, n_lights: int):
    """The Cull pass: the frustum test of the first `n_instances` instance
    and `n_lights` light AABBs of the pools (the padding rows past them are
    not visible) -> (instance_visible, light_valid, visible_counts (2,)
    int32)."""
    dev = instance_bounds.device
    vis = torch.zeros((instance_bounds.shape[0],), dtype=torch.bool, device=dev)
    if n_instances:
        vis[:n_instances] = common.frustum_cull_aabbs(
            frustum_planes, instance_bounds[:n_instances, 0], instance_bounds[:n_instances, 1])
    lv = torch.zeros((light_bounds.shape[0],), dtype=torch.bool, device=dev)
    if n_lights:
        lv[:n_lights] = common.frustum_cull_aabbs(
            frustum_planes, light_bounds[:n_lights, 0], light_bounds[:n_lights, 1])
    return vis, lv, torch.stack([vis.sum(), lv.sum()]).to(torch.int32)


def geometry(buffers, model_mats, normal_mats, instance_visible, view_proj,
             width: int, height: int):
    """Vertex transform + triangle setup + packed vertex attrs
    (gbuffer.hlsl:75-83 vertex stage + D3D fixed-function setup)."""
    clip = raster.vertex_transform(buffers["positions"], buffers["vtx_instance"],
                                   model_mats, view_proj)
    nrm_ws = raster.transform_directions(buffers["normals"], buffers["vtx_instance"],
                                         normal_mats)
    tan_ws = raster.transform_directions(buffers["tangents"], buffers["vtx_instance"],
                                         normal_mats)
    tri_ok = buffers["tri_valid_pool"] & instance_visible[buffers["tri_instance"].long()]
    setup = raster.setup_triangles(clip, buffers["tris"], tri_ok, width, height)
    vattrs = gbuffer.pack_vertex_attrs(buffers["uvs"], nrm_ws, tan_ws)
    return setup, vattrs


def binning(setup, width: int, band_h: int, tile_h: int, tile_w: int, bin_cap: int,
            y_offset=0):
    tiles_y, tiles_x = band_h // tile_h, width // tile_w
    t = setup.aabb.shape[0]
    # large pools: two-level binning cuts the per-tile compaction volume
    if t >= 16384 and tiles_y * tiles_x >= 64:
        return raster.bin_triangles_hier(setup, tiles_y, tiles_x, tile_h, tile_w, bin_cap,
                                         y_offset=y_offset, cap1=min(t, 8 * bin_cap))
    return raster.bin_triangles(setup, tiles_y, tiles_x, tile_h, tile_w, bin_cap,
                                y_offset=y_offset)


def rasterize(setup, bins, width: int, band_h: int, tile_h: int, tile_w: int,
              use_pallas: bool, y_offset=0, raster_caps: tuple | None = None, viewport=None):
    """Depth-only raster: (tri_id, z). With use_pallas, the depth-only kernel
    (kernel H) with the two-pass list limits `raster_caps` (cap_small,
    hot_k); otherwise the plain chunked fold over the whole lists.
    `viewport`: the (width, height) `setup` was made at, where the canvas is
    padded past it (`raster_cuda.raster_extents`)."""
    if use_pallas:
        cs, hk = raster_caps if raster_caps is not None else (None, None)
        return raster_cuda.rasterize_depth(setup, bins, width, band_h, tile_h, tile_w,
                                           y_offset=y_offset, cap_small=cs, hot_k=hk,
                                           viewport=viewport)
    return raster.rasterize(setup, bins, width, band_h, tile_h, tile_w, y_offset=y_offset)


def pack_rows64(setup, buffers, vattrs, viewport=None):
    """The (T, 64) per-triangle row shared by both G-buffer paths
    (raster_cuda.pack_rows64) with the triangle's material row and its three
    vertices' attribute rows as payload."""
    t = setup.edges.shape[0]
    payload = torch.cat([buffers["mat_rows"][buffers["tri_material"].long()],
                         vattrs[buffers["tris"].long()].reshape(t, 24)], dim=1)
    return raster_cuda.pack_rows64(setup, payload, viewport)


def rasterize_interp(setup, bins, buffers, vattrs, width: int, band_h: int, tile_h: int,
                     tile_w: int, y_offset=0, return_tiled: bool = False,
                     raster_caps: tuple | None = None, viewport=None):
    """Fused raster + attribute interpolation (kernel A): (tri_id, depth,
    planes (24, band_h, width)); with return_tiled, (tri_id, depth, pl_tiles,
    id_tiles, z_tiles) tile blocks for the fused G-buffer and deferred passes.
    `viewport`: as in `rasterize`."""
    rows64 = pack_rows64(setup, buffers, vattrs, viewport)
    cs, hk = raster_caps if raster_caps is not None else (None, None)
    return raster_cuda.rasterize_interp(setup, bins, rows64, width, band_h, tile_h, tile_w,
                                        y_offset=y_offset, cap_small=cs, hot_k=hk,
                                        return_tiled=return_tiled)


def gbuffer_shade(tri_id, depth, setup, buffers, vattrs, width: int, band_h: int,
                  texture_filter: str, y_offset=0, use_tex_kernel: bool = False,
                  tex_caps: tuple | None = None, tex_cascade=False) -> gbuffer.GBuffer:
    """G-buffer through the row-gather path (the use_pallas=False frame),
    sampling through the texture cache (kernels B or I, and E) with
    use_tex_kernel."""
    tri_rows = pack_rows64(setup, buffers, vattrs)
    return gbuffer.gbuffer_shade(tri_id, depth, tri_rows, buffers["atlas"], width, band_h,
                                 y_offset=y_offset, texture_filter=texture_filter,
                                 use_tex_kernel=use_tex_kernel, tex_caps=tex_caps,
                                 tex_cascade=tex_cascade)


def gbuffer_pass(buffers, model_mats, normal_mats, instance_visible, view_proj, width: int,
                 height: int, canvas_w: int, canvas_h: int, tile_h: int, tile_w: int,
                 bin_cap: int, route: Route, *, use_pallas: bool, texture_filter: str, tex_caps,
                 tex_cascade, raster_caps, y_offset=0):
    """The GBuffer pass of a frame, or of the band at `y_offset` on its
    (canvas_w, canvas_h) pad-to-tile canvas: geometry at the (width,
    height) viewport, binning, then the raster and the G-buffer shade of
    the route's path. On the fused G-buffer, kernel A's tile blocks feed
    the plan (kernels B and C); with `use_pallas`, kernel A's (H, W) planes
    feed the planar G-buffer; otherwise the plain depth fold feeds the row
    gather. Returns (GBuffer, bins, tiles): tiles (gb_tiles, z_tiles,
    id_tiles) for the fused deferred pass, else None."""
    viewport = (width, height)
    trace.stage("gbuffer.geometry", 2)
    setup, vattrs = geometry(buffers, model_mats, normal_mats, instance_visible, view_proj,
                             width, height)
    trace.stage("gbuffer.binning", 2)
    bins = binning(setup, canvas_w, canvas_h, tile_h, tile_w, bin_cap, y_offset=y_offset)
    trace.stage("gbuffer.raster", 2)
    if route.use_fused_gbuffer:
        tri_id, depth, pl_tiles, id_tiles, z_tiles = rasterize_interp(
            setup, bins, buffers, vattrs, canvas_w, canvas_h, tile_h, tile_w, y_offset=y_offset,
            return_tiled=True, raster_caps=raster_caps, viewport=viewport)
        trace.stage("gbuffer.tex_plan", 2)
        out = gbuffer.gbuffer_shade_fused(
            tri_id, depth, pl_tiles, id_tiles, buffers["atlas"], canvas_h, canvas_w, tile_h,
            tile_w, texture_filter, tex_caps=tex_caps, tex_cascade=tex_cascade,
            return_tiled=route.use_fused_deferred)
        if route.use_fused_deferred:
            gb, gb_tiles = out
            return gb, bins, (gb_tiles, z_tiles, id_tiles)
        return out, bins, None
    if use_pallas:
        tri_id, depth, planes = rasterize_interp(
            setup, bins, buffers, vattrs, canvas_w, canvas_h, tile_h, tile_w, y_offset=y_offset,
            raster_caps=raster_caps, viewport=viewport)
        trace.stage("gbuffer.tex_plan", 2)
        gb = gbuffer.gbuffer_shade_planar(
            tri_id, depth, planes, buffers["atlas"], texture_filter,
            use_tex_kernel=route.use_tex_kernel, tex_caps=tex_caps, tex_cascade=tex_cascade)
    else:
        tri_id, depth = rasterize(setup, bins, canvas_w, canvas_h, tile_h, tile_w, False,
                                  y_offset=y_offset, raster_caps=raster_caps, viewport=viewport)
        trace.stage("gbuffer.tex_plan", 2)
        gb = gbuffer_shade(tri_id, depth, setup, buffers, vattrs, canvas_w, canvas_h,
                           texture_filter=texture_filter, y_offset=y_offset,
                           use_tex_kernel=route.use_tex_kernel, tex_caps=tex_caps,
                           tex_cascade=tex_cascade)
    return gb, bins, None


def active_lights(buffers, light_valid, view, max_active: int):
    return clustered.build_active_lights(
        buffers["light_pos"], buffers["light_color"], buffers["light_intensity"],
        buffers["light_attenuation"], light_valid, view, max_active,
    )


def deferred_shade_fused(gb_tiles, z_tiles, id_tiles, buffers, active, inv_view, camera_pos,
                         config, width: int, band_h: int, tile_h: int, tile_w: int,
                         env_ids: tuple, y_offset=0, full_height: int | None = None,
                         full_width: int | None = None, env_budget: int | None = None,
                         light_dtype: str | None = None):
    """Fused deferred shading straight from the G-buffer tile blocks (env
    resolve + SH + split-sum + clustered lights + sky in kernel D, its light
    loop in `light_dtype`). Returns ((band_h, width, 3) HDR RT,
    env_approx_count)."""
    return shade_fused.deferred_shade_fused(
        gb_tiles, z_tiles, id_tiles, buffers["SkyBoxSH"], buffers["EnvCache"], active,
        inv_view, camera_pos, env_ids, config.fov, config.ratio, config.near, config.far,
        width, band_h, tile_h, tile_w, y_offset=y_offset, full_height=full_height,
        full_width=full_width, env_budget=env_budget, light_dtype=light_dtype)


def deferred_shade(gb: gbuffer.GBuffer, buffers, active, inv_view, camera_pos, config,
                   width: int, band_h: int, y_offset=0, full_height: int | None = None,
                   full_width: int | None = None, env_ids: tuple | None = None,
                   env_tile: tuple | None = None, env_budget: int | None = None,
                   return_env_approx: bool = False, light_tile: tuple | None = None,
                   light_cap: int = 256, return_light_counts: bool = False,
                   light_count: int | None = None):
    """The unfused deferred pass on (H, W) G-buffer planes: env taps through
    the float page cache when `env_ids` is given (kernels B and F), point
    lights per light tile when `light_tile` is given (kernel G), else the
    dense sweep over at most `light_count` active rows."""
    return shading.deferred_shade(
        gb.albedo_emission, gb.normal_oct, gb.rough_metal_ao, gb.depth, gb.mask,
        buffers["SkyBoxSH"], buffers["PrecomputeBRDF"], buffers["PrefilterEnvMap"],
        buffers["SkyBoxTexture"], active, inv_view, camera_pos,
        config.fov, config.ratio, config.near, config.far, width, band_h,
        y_offset=y_offset, full_height=full_height, full_width=full_width,
        env_cache=buffers.get("EnvCache") if env_ids is not None else None,
        env_ids=env_ids, env_tile=env_tile, env_budget=env_budget,
        return_env_approx=return_env_approx, light_tile=light_tile, light_cap=light_cap,
        return_light_counts=return_light_counts, light_count=light_count,
    )


def deferred_shading(route: Route, gb: gbuffer.GBuffer, tiles, buffers, active, inv_view,
                     camera_pos, config, canvas_w: int, canvas_h: int, tile_h: int, tile_w: int,
                     *, full_width: int, full_height: int, y_offset=0, env_budget: int | None,
                     light_dtype: str | None, light_tile: tuple | None, light_cap: int,
                     light_count: int):
    """The DeferredShading pass of a frame, or of the band at `y_offset`, on
    its (canvas_w, canvas_h) canvas: the fused pass (kernel D, its light
    loop in `light_dtype`) from `gbuffer_pass`'s tile blocks where the route
    takes it, else the unfused pass on the G-buffer planes (`deferred_shade`).
    Returns (RT (canvas_h, canvas_w, 3), env_approx, light_trunc): the env
    taps left to the fallback and the most culled lights any light tile
    held beyond `light_cap` (0 on the fused pass)."""
    zero = torch.zeros((), dtype=torch.int32, device=active.device)
    if route.use_fused_deferred:
        # env resolve + SH + split-sum + clustered lights + sky in kernel D,
        # on the G-buffer tile blocks; the pixel coordinates ride y_offset
        gb_tiles, z_tiles, id_tiles = tiles
        rt, env_approx = deferred_shade_fused(
            gb_tiles, z_tiles, id_tiles, buffers, active, inv_view, camera_pos, config, canvas_w,
            canvas_h, tile_h, tile_w, route.env_ids, y_offset=y_offset, full_height=full_height,
            full_width=full_width, env_budget=env_budget, light_dtype=light_dtype)
        return rt, env_approx, zero
    # with a light tile the counts are those of the pass's own
    # lights_cuda.tile_light_lists(..., y_offset) call
    rt, env_approx, light_counts = deferred_shade(
        gb, buffers, active, inv_view, camera_pos, config, canvas_w, canvas_h, y_offset=y_offset,
        full_height=full_height, full_width=full_width, env_ids=route.env_ids,
        env_tile=route.env_tile, env_budget=env_budget, return_env_approx=True,
        light_tile=light_tile, light_cap=light_cap, return_light_counts=True,
        light_count=light_count)
    # per-tile culled-light counts beyond the cap: truncation
    trunc = zero if light_counts is None else torch.clamp(light_counts - light_cap, min=0).max()
    return rt, env_approx, trunc
