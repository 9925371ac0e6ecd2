"""Deferred shading pass — counterpart of `ops/shading.py` (the unfused
pass; the fused one is `ops/shade_fused.py`).

Mirrors `deferred_shading.hlsl` with its quirks (the directional light is
computed but never added, AO is read but unused): SH ambient diffuse +
split-sum specular + clustered point lights + emission, and the deferred
skybox on uncovered pixels. Both of the JAX package's switches are kept:
* `env_ids`: the env taps (trilinear halves, BRDF LUT, sky, mip+3 cascade)
  through the float page cache (`envcache.env_plan` plans, kernel F
  resolves); without it, direct cube-atlas / LUT sampler taps;
* `light_tile`: the tile-clustered point lights (`lights_cuda`, kernel G),
  the 1024-light operating point; without it, a serial sweep over the
  compacted active lights.
"""

from __future__ import annotations

import functools
import math

import torch

from ..config import MAX_LIGHTS_PER_CLUSTER, PREFILTER_ENVMAP_MIP_LEVELS

from ..utils import trace
from . import common, envcache, lights_cuda
from .clustered import CLUSTER_X, CLUSTER_Y, CLUSTER_Z


def view_space_depth(ndc_depth, near, far):
    """ndc z [0,1] -> view z [near, far] (deferred_shading.hlsl:76-79)."""
    return near * far / (far - ndc_depth * (far - near))


@functools.lru_cache(maxsize=None)
def _tan_half_fov(fov: float, device: torch.device) -> torch.Tensor:
    """tan(fov / 2) in float32 on `device`, computed there once per key and
    then reused (a frame makes no host-to-device copy for it)."""
    return torch.tan(torch.tensor(fov / 2.0, dtype=torch.float32, device=device))


def camera_rays(width, height, inv_view, fov, ratio, near, y_offset=0,
                full_height=None, full_width=None):
    """Per-pixel world-space camera->near-plane vectors (H, W, 3): the
    reference's corner-interpolated camera_vec, evaluated per pixel."""
    dev = inv_view.device
    near_h = 2.0 * near * _tan_half_fov(fov, dev)
    near_w = near_h * ratio
    fh = full_height if full_height is not None else height
    fw = full_width if full_width is not None else width
    v = ((torch.arange(height, dtype=torch.float32, device=dev) + 0.5 + y_offset) / fh)[:, None]
    u = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / fw)[None, :]
    u, v = torch.broadcast_tensors(u, v)
    cam = torch.stack([(u - 0.5) * near_w, (0.5 - v) * near_h, torch.full_like(u, near)], -1)
    rot = inv_view[:3, :3]
    return (cam[..., None, :] * rot).sum(-1)


def pixel_view_geometry(depth, normal, inv_view, camera_pos, width, height, fov, ratio,
                        near, far, y_offset=0, full_height=None, full_width=None):
    """(position, view_dir, z_view, n_dot_v, refl, ray) per pixel from the
    depth buffer + decoded normals (deferred_shading.hlsl:96-110)."""
    cam_vec = camera_rays(width, height, inv_view, fov, ratio, near, y_offset,
                          full_height, full_width)
    z_view = view_space_depth(depth, near, far)
    position = camera_pos[None, None, :] + cam_vec * (z_view / near)[..., None]
    view_dir = common.normalize(camera_pos[None, None, :] - position, 1e-20)
    n_dot_v = torch.clamp((normal * view_dir).sum(-1), min=0.0)
    refl = 2.0 * (normal * view_dir).sum(-1, keepdim=True) * normal - view_dir
    refl = common.normalize(refl, 1e-20)
    ray = common.normalize(cam_vec, 1e-20)
    return position, view_dir, z_view, n_dot_v, refl, ray


def env_tap_groups(refl, ray, roughness, n_dot_v, mask, env_ids):
    """The deferred pass's env-cache tap groups: per-pixel (tex, mip, u, v,
    active) stacks (..., G) for the env trilinear halves, the BRDF LUT, the
    background sky and (when env content exists) the mip+3 LOD-clamp
    cascade, plus the matching fb_tids/caps. Returns (tex, mip, u, v, act,
    fb_tids, caps, fracm, has_env)."""
    env_base, sky_base, lut_tid, env_mips, has_env, fb_tids, caps = envcache.env_groups(env_ids)
    lo, fracm = envcache.env_mip_level(roughness, env_mips)
    hi = torch.clamp(lo + 1, max=env_mips - 1)
    face_e, ue, ve = common.cubemap_coords(refl)
    face_s, us, vs = common.cubemap_coords(ray)
    zero = torch.zeros_like(lo)
    tex_e = env_base + face_e
    groups = [
        (tex_e, lo, ue, ve, mask),
        (tex_e, hi, ue, ve, mask),
        (torch.full_like(lo, lut_tid), zero, roughness, n_dot_v, mask),
        (sky_base + face_s, zero, us, vs, ~mask),
    ]
    if has_env:
        # LOD-clamp cascade: mip+3 re-taps resolve mirror-tile footprints that
        # overflow the mip-0 budget at a mild blur (only with env content)
        groups.append((tex_e, torch.clamp(lo + 3, max=env_mips - 1), ue, ve, mask))
    return (*(torch.stack([gr[i] for gr in groups], -1) for i in range(5)), fb_tids, caps,
            fracm, has_env)


def deferred_shade(
    gb_albedo_emission,   # (H, W, 4)
    gb_normal_oct,        # (H, W, 2)
    gb_rough_metal_ao,    # (H, W, 3)
    depth,                # (H, W) ndc z
    mask,                 # (H, W) bool coverage
    sh_pack,              # (7, 4) SkyBoxSH
    brdf_lut_quad,        # ((S*S, 4, 2) quad records, S) for the split-sum LUT
    prefiltered,          # common.CubeMipAtlas of the prefiltered mips
    skybox,               # common.CubeMipAtlas (1 mip) for the background
    active_lights,        # (N_active, 14) from clustered.build_active_lights
    inv_view, camera_pos,
    fov, ratio, near, far,
    width: int,
    height: int,
    y_offset=0,
    full_height: int | None = None,
    full_width: int | None = None,
    env_cache=None,                 # envcache.FloatAtlas (with env_ids), or None
    env_ids: tuple | None = None,   # (env_base, sky_base, lut_tid, env_mips[, has_env])
    env_tile: tuple | None = None,  # the env cache's (tile_h, tile_w)
    env_budget: int | None = None,  # its staging page budget (None: worst case)
    return_env_approx: bool = False,
    light_tile: tuple | None = None,  # (tile_h, tile_w): tile-clustered lights
    light_cap: int = 256,             # listed lights per light tile
    return_light_counts: bool = False,
    light_count: int | None = None,   # the scene's lights: bounds the dense sweep
):
    """-> (H, W, 3) HDR radiance, and with `return_env_approx` the env
    fallback-tap count (() int32; 0 without the env cache), then with
    `return_light_counts` the per-light-tile culled-light counts ((tiles,)
    int32; None without `light_tile`; counts > light_cap is truncation). The dense
    point-light sweep walks the active rows in order with a per-pixel
    `< MAX_LIGHTS_PER_CLUSTER` hit counter; its trip count is static, the
    active rows or, given `light_count`, at most that many, and the rows
    past the JAX sweep's device-valued trip count never hit. The tiled
    lights give the same cluster membership, order and cap."""
    albedo = gb_albedo_emission[..., :3]
    emission = gb_albedo_emission[..., 3]
    normal = common.decode_octahedron(gb_normal_oct)
    roughness = gb_rough_metal_ao[..., 0]
    metallic = gb_rough_metal_ao[..., 1]

    position, view_dir, z_view, n_dot_v, refl, ray = pixel_view_geometry(
        depth, normal, inv_view, camera_pos, width, height, fov, ratio,
        near, far, y_offset, full_height, full_width,
    )

    # --- environment diffuse: SH polynomial (deferred_shading.hlsl:23-54) ---
    n = normal
    a4 = torch.cat([n, torch.ones_like(n[..., :1])], -1)
    b4 = torch.stack([n[..., 0] * n[..., 1], n[..., 1] * n[..., 2], n[..., 2] * n[..., 2],
                      n[..., 2] * n[..., 0]], -1)
    c1 = n[..., 0] * n[..., 0] - n[..., 1] * n[..., 1]
    l0l1 = torch.stack([(a4 * sh_pack[i]).sum(-1) for i in (0, 2, 4)], -1)
    l2 = torch.stack([(b4 * sh_pack[i]).sum(-1) for i in (1, 3, 5)], -1)
    l2 = l2 + sh_pack[6, :3] * c1[..., None]
    irradiance = l0l1 + l2
    kd = albedo * (1.0 - metallic[..., None]) * common.INV_PI
    env_diffuse = kd * irradiance

    # --- environment specular: split-sum (deferred_shading.hlsl:56-70) -----
    if env_ids is not None:
        # the four sampler taps (env trilinear halves, BRDF LUT, background
        # sky) and the cascade through one float page-cache plan + resolve
        trace.begin("shade.env_plan")
        *plan, env_approx_cnt, fracm, has_env = envcache.env_plan(
            env_cache, refl, ray, roughness, n_dot_v, mask, env_ids, tile=env_tile,
            stage_budget=env_budget)
        trace.end("shade.env_plan")
        rgba, covered = envcache.resolve_untiled(plan, *refl.shape[:2], *env_tile)
        env_exact = rgba[..., 0, :3] * (1 - fracm) + rgba[..., 1, :3] * fracm
        # group 0 holds the coarse fallback; with env content the mip+3
        # cascade (group 4) comes first
        coarse = (torch.where(covered[..., 4, None], rgba[..., 4, :3], rgba[..., 0, :3])
                  if has_env else rgba[..., 0, :3])
        env_irr = torch.where(covered[..., 0, None], env_exact, coarse)
        env_brdf = rgba[..., 2, :2]
        sky = rgba[..., 3, :3]
    else:
        env_irr = common.sample_cube_atlas_trilinear(
            prefiltered, refl, roughness * PREFILTER_ENVMAP_MIP_LEVELS)[..., :3]
        lut, lut_size = brdf_lut_quad
        env_brdf = common.sample_quad_tex2d(lut, lut_size, lut_size, roughness, n_dot_v)
        sky = None
        env_approx_cnt = torch.zeros((), dtype=torch.int32, device=depth.device)
    f0 = common.compute_f0(albedo, metallic[..., None])
    env_specular = env_irr * (f0 * env_brdf[..., 0:1] + env_brdf[..., 1:2])

    def result(out, light_counts=None):
        extra = ((env_approx_cnt,) if return_env_approx else ()) + (
            (light_counts,) if return_light_counts else ())
        return (out,) + extra if extra else out

    # --- clustered point lights (deferred_shading.hlsl:158-186) ------------
    if light_tile is not None:
        # the 1024-light operating point: O(lights per tile), kernel G
        point_light, light_counts = lights_cuda.point_lights_tiled(
            active_lights, albedo, normal, roughness, metallic, z_view, mask, inv_view,
            camera_pos, fov, ratio, near, far, width, height, tile_h=light_tile[0],
            tile_w=light_tile[1], y_offset=y_offset, full_height=full_height,
            full_width=full_width, cap=light_cap)
        lit = env_diffuse + env_specular + point_light + albedo * emission[..., None]
        if sky is None:
            sky = common._cube_atlas_bilinear(skybox, ray, 0)[..., :3]
        return result(torch.where(mask[..., None], lit, sky), light_counts)

    # per-pixel cluster AABB in closed form (clustered_compute.hlsl:21-42)
    dev = depth.device
    fh = full_height if full_height is not None else height
    fw = full_width if full_width is not None else width
    u = (torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5) / fw
    v = (torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5 + y_offset) / fh
    sx = torch.clamp(torch.floor(u * CLUSTER_X), 0, CLUSTER_X - 1)
    sy = torch.clamp(torch.floor((1.0 - v) * CLUSTER_Y), 0, CLUSTER_Y - 1)
    zc_ = torch.clamp(z_view, near, far)
    szf = torch.clamp(
        torch.floor(CLUSTER_Z * torch.log(zc_ / near) / math.log(far / near)),
        0, CLUSTER_Z - 1,
    )
    sx = sx.expand(depth.shape)
    sy = sy.expand(depth.shape)
    tan_half = math.tan(fov / 2.0)
    znear_c = near * torch.pow(far / near, szf / CLUSTER_Z)
    zfar_c = near * torch.pow(far / near, (szf + 1) / CLUSTER_Z)

    def corner(ndc_x, ndc_y, vz):
        return (ndc_x * ratio * tan_half * vz, ndc_y * tan_half * vz)

    min_ndc_x = 2.0 * sx / CLUSTER_X - 1.0
    min_ndc_y = 2.0 * sy / CLUSTER_Y - 1.0
    max_ndc_x = 2.0 * (sx + 1) / CLUSTER_X - 1.0
    max_ndc_y = 2.0 * (sy + 1) / CLUSTER_Y - 1.0
    xa, ya = corner(min_ndc_x, min_ndc_y, znear_c)
    xb, yb = corner(min_ndc_x, min_ndc_y, zfar_c)
    xc, yc = corner(max_ndc_x, max_ndc_y, znear_c)
    xd, yd = corner(max_ndc_x, max_ndc_y, zfar_c)
    cmin = torch.stack([torch.minimum(torch.minimum(xa, xb), torch.minimum(xc, xd)),
                        torch.minimum(torch.minimum(ya, yb), torch.minimum(yc, yd)),
                        znear_c], -1)
    cmax = torch.stack([torch.maximum(torch.maximum(xa, xb), torch.maximum(xc, xd)),
                        torch.maximum(torch.maximum(ya, yb), torch.maximum(yc, yd)),
                        zfar_c], -1)

    # JAX walks rows [0, n_active), n_active the rows with cull_r > 0, a
    # device value; here the trip count is static (no host read) and the
    # rows at or past n_active get a zero cull radius on the device, so they
    # never hit and the select below leaves acc and counter bit-unchanged
    n_rows = active_lights.shape[0]
    if light_count is not None:
        n_rows = min(n_rows, light_count)
    n_active = (active_lights[:, 13] > 0.0).sum()
    cull = torch.where(torch.arange(n_rows, device=dev) < n_active,
                       active_lights[:n_rows, 13], 0.0)
    acc = torch.zeros(depth.shape + (3,), dtype=torch.float32, device=dev)
    counter = torch.zeros(depth.shape, dtype=torch.int32, device=dev)
    for s in range(n_rows):
        lp = active_lights[s]
        pos_w, color, intensity = lp[0:3], lp[3:6], lp[6]
        kc, kl, kq = lp[7], lp[8], lp[9]
        pos_view, cull_r = lp[10:13], cull[s]

        closest = torch.minimum(torch.maximum(pos_view, cmin), cmax)
        d2 = ((pos_view - closest) ** 2).sum(-1)
        hit = (d2 < cull_r * cull_r) & (counter < MAX_LIGHTS_PER_CLUSTER)

        ldir = pos_w - position
        dist = torch.linalg.vector_norm(ldir, dim=-1)
        ldir = ldir / torch.clamp(dist[..., None], min=1e-20)
        n_dot_l = torch.clamp((normal * ldir).sum(-1), min=0.0)
        attenuation = 1.0 / torch.clamp(kc + kl * dist + kq * dist * dist, min=common.EPSILON)
        f = common.brdf(albedo, metallic, roughness, normal, view_dir, ldir)
        contrib = f * (color * (intensity * attenuation * n_dot_l)[..., None])
        acc = acc + torch.where(hit[..., None], contrib, 0.0)
        counter = counter + hit.to(torch.int32)

    lit = env_diffuse + env_specular + acc + albedo * emission[..., None]
    # --- skybox (skybox.hlsl): background pixels sample the cubemap --------
    if sky is None:
        sky = common._cube_atlas_bilinear(skybox, ray, 0)[..., :3]
    return result(torch.where(mask[..., None], lit, sky))
