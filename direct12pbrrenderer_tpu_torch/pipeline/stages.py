"""Per-band render stages — counterpart of `pipeline/stages.py`.

One implementation of the heavy frame stages, shared by the pipeline (a
full frame is one band at y_offset 0) and by measurement scripts that time
a stage in isolation.
"""

from __future__ import annotations

import torch

from ..ops import clustered, gbuffer, raster, raster_cuda, shade_fused, shading


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
