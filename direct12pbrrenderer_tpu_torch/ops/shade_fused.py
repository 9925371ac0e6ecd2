"""Fused deferred shading on the G-buffer's tile blocks — counterpart of
`ops/shade_pallas.py` (kernel D).

`deferred_shade_fused` computes the tiled per-pixel geometry, the env-cache
plan (`envcache.env_plan`: its kernels around kernel B) and the 64-float
`const` vector, then runs kernel D: env-page resolve (bf16 pairs),
SH2 irradiance diffuse, split-sum specular, the clustered point-light loop
over the frame's compacted active lights with the per-cluster cap-32 counter,
emission, and the sky on background pixels (deferred_shading.hlsl:23-186,
skybox.hlsl).

`deferred_kernel` launches the hand-written CUDA kernel
`csrc/deferred_shade.cu` for CUDA tensors, reading the per-pixel planes in
place through their strides (`tap_planes.plane_strides`); for CPU tensors
it runs `deferred_kernel_reference`, the plain PyTorch version. There is no fallback
between the two: a CUDA input either launches the kernel or raises. Both
mask each light's contribution with a select (the TPU kernel multiplies by
a 0/1 gate, which lets a NaN of a degenerate light row through); on finite
values the two agree exactly.

`light_dtype` (the pipeline's `fused_light_dtype`) selects the TPU kernel's
light-loop instance (shade_pallas.py:218-312): None, float32 with division;
or "float32", "bfloat16", "float16", where the loop-invariant per-pixel
fields and each light row's words 0-9 are cast once to that type, every
product and sum of a light's body is rounded to it, sqrt and the reciprocal
go through float32 (a division is a * T(1 / float32(b))), every Python
constant is rounded to it first (JAX's weak typing), the cluster-sphere test
stays in float32 and each channel's contribution is accumulated in float32.
"""

from __future__ import annotations

import functools
import math

import torch

from ..config import (
    CLUSTER_X,
    CLUSTER_Y,
    CLUSTER_Z,
    MAX_LIGHTS_PER_CLUSTER,
)

from ..kernels.launch import Entry
from ..utils import trace
from . import common, envcache, tap_planes
from .env_resolve_cuda import resolve_env_group
from .texcache import _untile

_EPS = 1e-6
_INV_PI = 0.31830988618
_PI = 3.14159265359
GB_CH = 14    # kernel gb channels [albedo(3), emission, normal(3), roughness,
              # metallic, z_view, mask, fracm, cov0, cov4]
CONST_LEN = 64
MAX_LIGHTS = 64
_LAUNCH = Entry("deferred_shade", "deferred_shade_launch", "ppipppiPsiiiiiiiip")
# the light loop's instances: None (float32, division) and the TPU kernel's
# light_dtype values, with the code deferred_shade_launch selects them by
LIGHT_DTYPES = {None: (torch.float32, 0), "float32": (torch.float32, 1),
                "bfloat16": (torch.bfloat16, 2), "float16": (torch.float16, 3)}


def check_light_dtype(light_dtype) -> None:
    if light_dtype not in LIGHT_DTYPES:
        raise ValueError(f"light_dtype must be one of {list(LIGHT_DTYPES)}, got "
                         f"{light_dtype!r}")


def deferred_kernel(const, lights, off, cnts, staged, rec, fx, fy, gb, *, has_env: bool,
                    tile_h: int, tile_w: int, tiles_x: int, light_dtype: str | None = None):
    """Kernel D on one frame's tiles. const (64,) f32 [tan_half, ratio,
    near, far, cam(3), yoff, R(9) row-major inv_view[:3,:3], fw, fh,
    log(far/near), far/near, n_active, pad(2), sh_pack(28), pad]; lights
    (L <= 64, 14) active-light rows; off/cnts (tiles, G) int32; staged
    (tiles, B*8, 128) int32 env pages; rec/fx/fy (tiles, G, blocks, 128); gb
    (tiles, 14, blocks, 128) f32; light_dtype one of LIGHT_DTYPES. ->
    (tiles, 4, blocks, 128) f32 [rgb, cluster-hit counter]."""
    check_light_dtype(light_dtype)
    if rec.device.type == "cpu":
        return deferred_kernel_reference(const, lights, off, cnts, staged, rec, fx, fy, gb,
                                         has_env=has_env, tile_h=tile_h, tile_w=tile_w,
                                         tiles_x=tiles_x, light_dtype=light_dtype)
    if rec.device.type != "cuda":
        raise ValueError(f"deferred_kernel: unsupported device {rec.device}")
    tiles, n_groups, blocks, lanes = rec.shape
    if lanes != 128 or n_groups != 4 + has_env:
        raise ValueError(f"rec must be (tiles, {4 + has_env}, blocks, 128), got "
                         f"{tuple(rec.shape)}")
    if lights.dim() != 2 or lights.shape[1] != 14 or not 0 < lights.shape[0] <= MAX_LIGHTS:
        raise ValueError(f"lights must be (1..{MAX_LIGHTS}, 14), got {tuple(lights.shape)}")
    if tile_w % 128 or blocks * 128 != tile_h * tile_w:
        raise ValueError(f"{blocks} lane rows do not make a {tile_h}x{tile_w} tile")
    shapes = {"const": (const, (CONST_LEN,), torch.float32),
              "lights": (lights, tuple(lights.shape), torch.float32),
              "off": (off, (tiles, n_groups), torch.int32),
              "cnts": (cnts, (tiles, n_groups), torch.int32),
              "rec": (rec, tuple(rec.shape), torch.int32),
              "fx": (fx, tuple(rec.shape), torch.float32),
              "fy": (fy, tuple(rec.shape), torch.float32),
              "gb": (gb, (tiles, GB_CH, blocks, 128), torch.float32)}
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != rec.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {rec.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if (staged.dtype != torch.int32 or staged.dim() != 3 or staged.shape[0] != tiles
            or staged.shape[1] % envcache.REC_I32 or staged.shape[2] != 128
            or staged.device != rec.device):
        raise ValueError(f"staged must be (tiles, B*8, 128) int32 on {rec.device}, got "
                         f"{tuple(staged.shape)} {staged.dtype} on {staged.device}")
    # the per-pixel planes are read in place through their strides (the env
    # plan's arrive with the group innermost): no copy. The rest is built
    # contiguous.
    ptrs, strides = tap_planes.plane_args({"rec": rec, "fx": fx, "fy": fy, "gb": gb})
    for name, x in (("const", const), ("lights", lights), ("off", off), ("cnts", cnts),
                    ("staged", staged)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {x.stride()}")
    dev = rec.device
    out = torch.empty((tiles, 4, blocks, 128), dtype=torch.float32, device=dev)
    # a light_dtype's launches also count under the instance's own name
    _LAUNCH(dev, const.data_ptr(), lights.data_ptr(), lights.shape[0], off.data_ptr(),
            cnts.data_ptr(), staged.data_ptr(), staged.shape[1] // envcache.REC_I32, ptrs,
            strides, tiles, n_groups, blocks, int(has_env), tile_h, tile_w, tiles_x,
            LIGHT_DTYPES[light_dtype][1], out.data_ptr(),
            also=(f"deferred_shade_{light_dtype}",) if light_dtype is not None else ())
    return out


# ------------------------------------------------------- plain version ----
def deferred_kernel_reference(const, lights, off, cnts, staged, rec, fx, fy, gb, *,
                              has_env: bool, tile_h: int, tile_w: int, tiles_x: int,
                              light_dtype: str | None = None):
    """Plain PyTorch version of kernel D: the same per-pixel formulas in the
    same order over whole (tiles, blocks, 128) planes; the light loop's trip
    count is read to the host. In a 16-bit light_dtype each sum and product
    of a light's body is one torch op on tensors of that type: float32
    arithmetic rounded once, the correctly rounded result, as the kernel's
    `_rn` intrinsics give."""
    check_light_dtype(light_dtype)
    n_tiles, n_groups, blocks, _ = rec.shape
    dev = rec.device
    res = [resolve_env_group(off, cnts, staged, rec, fx, fy, g) for g in range(n_groups)]
    alb = [gb[:, 0], gb[:, 1], gb[:, 2]]
    emission = gb[:, 3]
    nx, ny, nz = gb[:, 4], gb[:, 5], gb[:, 6]
    rough, metal = gb[:, 7], gb[:, 8]
    z_view = gb[:, 9]
    mask = gb[:, 10] > 0.5
    fracm = gb[:, 11]
    cov0 = gb[:, 12] > 0.5
    cov4 = gb[:, 13] > 0.5

    # environment specular: split-sum (deferred_shading.hlsl:56-70)
    env_irr = []
    for c in range(3):
        exact = res[0][c] * (1.0 - fracm) + res[1][c] * fracm
        fallback = torch.where(cov4, res[4][c], res[0][c]) if has_env else res[0][c]
        env_irr.append(torch.where(cov0, exact, fallback))
    lut_a, lut_b = res[2][0], res[2][1]
    sky = res[3]
    f0 = [0.04 * (1.0 - metal) + alb[c] * metal for c in range(3)]
    env_spec = [env_irr[c] * (f0[c] * lut_a + lut_b) for c in range(3)]

    # environment diffuse: SH2 polynomial (hlsl:23-54)
    sh = const[24:52]
    b0_, b1_, b2_, b3_ = nx * ny, ny * nz, nz * nz, nz * nx
    c1 = nx * nx - ny * ny

    def irr_ch(r_a, r_b, c6):
        a = nx * sh[4 * r_a] + ny * sh[4 * r_a + 1] + nz * sh[4 * r_a + 2] + sh[4 * r_a + 3]
        b = (b0_ * sh[4 * r_b] + b1_ * sh[4 * r_b + 1] + b2_ * sh[4 * r_b + 2]
             + b3_ * sh[4 * r_b + 3])
        return a + b + sh[24 + c6] * c1

    irr = [irr_ch(0, 1, 0), irr_ch(2, 3, 1), irr_ch(4, 5, 2)]
    kd_alb = [alb[c] * ((1.0 - metal) * _INV_PI) for c in range(3)]
    env_diff = [kd_alb[c] * irr[c] for c in range(3)]

    # per-pixel position and view vector (the kernel's own reconstruction)
    tan_half, ratio, near, far = const[0], const[1], const[2], const[3]
    camx, camy, camz = const[4], const[5], const[6]
    yoff, fw, fh, log_zr, fn_ratio = const[7], const[17], const[18], const[19], const[20]
    n_active = min(int(const[21].item()), lights.shape[0])
    wb = tile_w // 128
    t = torch.arange(n_tiles, device=dev)[:, None, None]
    bidx = torch.arange(blocks, device=dev)[None, :, None]
    lane = torch.arange(128, device=dev)[None, None, :]
    row = (bidx // wb).float()
    col = ((bidx % wb) * 128 + lane).float()
    ox = ((t % tiles_x) * tile_w).float()
    oy = ((t // tiles_x) * tile_h).float()
    u = (col + 0.5 + ox) / fw
    v = (row + 0.5 + oy + yoff) / fh
    near_h = 2.0 * near * tan_half
    near_w = near_h * ratio
    cx_ = (u - 0.5) * near_w
    cy_ = (0.5 - v) * near_h
    scale = z_view / near
    posx = camx + (const[8] * cx_ + const[9] * cy_ + const[10] * near) * scale
    posy = camy + (const[11] * cx_ + const[12] * cy_ + const[13] * near) * scale
    posz = camz + (const[14] * cx_ + const[15] * cy_ + const[16] * near) * scale
    vdx, vdy, vdz = camx - posx, camy - posy, camz - posz
    # 1 / sqrt, both correctly rounded, as the CUDA kernel computes it (the
    # TPU kernel's rsqrt is within an ulp of it; torch.rsqrt on the card is
    # the approximate rsqrtf)
    inv_vl = 1.0 / torch.sqrt(torch.clamp(vdx * vdx + vdy * vdy + vdz * vdz, min=1e-40))
    vdx, vdy, vdz = vdx * inv_vl, vdy * inv_vl, vdz * inv_vl
    n_dot_v = torch.clamp(nx * vdx + ny * vdy + nz * vdz, min=0.0)

    # per-pixel cluster AABB (clustered_compute.hlsl:21-42 in closed form)
    sx = torch.clamp(torch.floor(u * CLUSTER_X), 0, CLUSTER_X - 1)
    sy = torch.clamp(torch.floor((1.0 - v) * CLUSTER_Y), 0, CLUSTER_Y - 1)
    zc_ = torch.minimum(torch.maximum(z_view, near), far)
    szf = torch.clamp(torch.floor(CLUSTER_Z * torch.log(zc_ / near) / log_zr), 0, CLUSTER_Z - 1)
    znear_c = near * torch.pow(fn_ratio, szf / CLUSTER_Z)
    zfar_c = near * torch.pow(fn_ratio, (szf + 1) / CLUSTER_Z)
    min_nx = 2.0 * sx / CLUSTER_X - 1.0
    min_ny = 2.0 * sy / CLUSTER_Y - 1.0
    max_nx = 2.0 * (sx + 1) / CLUSTER_X - 1.0
    max_ny = 2.0 * (sy + 1) / CLUSTER_Y - 1.0
    xa, xb = min_nx * ratio * tan_half * znear_c, min_nx * ratio * tan_half * zfar_c
    xc, xd = max_nx * ratio * tan_half * znear_c, max_nx * ratio * tan_half * zfar_c
    ya, yb = min_ny * tan_half * znear_c, min_ny * tan_half * zfar_c
    yc, yd = max_ny * tan_half * znear_c, max_ny * tan_half * zfar_c
    cminx = torch.minimum(torch.minimum(xa, xb), torch.minimum(xc, xd))
    cmaxx = torch.maximum(torch.maximum(xa, xb), torch.maximum(xc, xd))
    cminy = torch.minimum(torch.minimum(ya, yb), torch.minimum(yc, yd))
    cmaxy = torch.maximum(torch.maximum(ya, yb), torch.maximum(yc, yd))

    a2 = (rough * rough) * (rough * rough)
    k_geo = (rough + 1.0) * (rough + 1.0) * (1.0 / 8.0)
    g_v = n_dot_v / torch.clamp(n_dot_v * (1.0 - k_geo) + k_geo, min=_EPS)

    # the light loop's type (shade_pallas.py:218-245; the module docstring)
    if light_dtype is None:
        def ldc(x):
            return x

        def k(v):
            return v

        sqrt_ = torch.sqrt

        def div(a, b):
            return a / b
    else:
        ld = LIGHT_DTYPES[light_dtype][0]

        def ldc(x):
            return x.to(ld)

        def k(v):
            return torch.tensor(v, dtype=ld, device=dev)

        def sqrt_(x):
            return torch.sqrt(x.float()).to(ld)

        def div(a, b):
            return a * (1.0 / b.float()).to(ld)
    l_px, l_py, l_pz = ldc(posx), ldc(posy), ldc(posz)
    l_vdx, l_vdy, l_vdz = ldc(vdx), ldc(vdy), ldc(vdz)
    l_nx, l_ny, l_nz = ldc(nx), ldc(ny), ldc(nz)
    l_ndv, l_a2, l_kgeo, l_gv = ldc(n_dot_v), ldc(a2), ldc(k_geo), ldc(g_v)
    l_f0 = [ldc(f) for f in f0]
    l_kd = [ldc(x) for x in kd_alb]
    one, zero, eps = k(1.0), k(0.0), k(_EPS)

    # clustered point lights (hlsl:158-186): serial, so the cap-32 counter
    # admits lights in row order exactly
    acc = [torch.zeros_like(z_view) for _ in range(3)]
    counter = torch.zeros_like(z_view)
    for s in range(n_active):
        lp = lights[s]
        # the cluster-sphere test stays float32 under every light_dtype
        dx = lp[10] - torch.minimum(torch.maximum(lp[10], cminx), cmaxx)
        dy = lp[11] - torch.minimum(torch.maximum(lp[11], cminy), cmaxy)
        dz = lp[12] - torch.minimum(torch.maximum(lp[12], znear_c), zfar_c)
        hit = ((dx * dx + dy * dy + dz * dz) < lp[13] * lp[13]) & (
            counter < float(MAX_LIGHTS_PER_CLUSTER))
        lw = [ldc(lp[i]) for i in range(10)]
        ldx, ldy, ldz = lw[0] - l_px, lw[1] - l_py, lw[2] - l_pz
        dist = sqrt_(ldx * ldx + ldy * ldy + ldz * ldz)
        inv_d = div(one, torch.clamp(dist, min=k(1e-20)))
        ldx, ldy, ldz = ldx * inv_d, ldy * inv_d, ldz * inv_d
        n_dot_l = torch.clamp(l_nx * ldx + l_ny * ldy + l_nz * ldz, min=zero)
        hx, hy, hz = ldx + l_vdx, ldy + l_vdy, ldz + l_vdz
        inv_h = div(one, torch.clamp(sqrt_(hx * hx + hy * hy + hz * hz), min=eps))
        n_dot_h = torch.clamp((l_nx * hx + l_ny * hy + l_nz * hz) * inv_h, min=zero)
        t_ = n_dot_h * n_dot_h * (l_a2 - one) + one
        d_ggx = div(l_a2, torch.clamp(k(_PI) * t_ * t_, min=eps))
        g_l = div(n_dot_l, torch.clamp(n_dot_l * (one - l_kgeo) + l_kgeo, min=eps))
        spec_s = div(d_ggx * (l_gv * g_l), torch.clamp(k(4.0) * n_dot_l * l_ndv, min=k(1e-4)))
        one_m = torch.clamp(one - n_dot_l, min=eps)
        om2 = one_m * one_m
        pow5 = om2 * om2 * one_m
        att = div(one, torch.clamp(lw[7] + lw[8] * dist + lw[9] * (dist * dist), min=eps))
        lum = lw[6] * att * n_dot_l
        for c in range(3):
            fres = l_f0[c] + (one - l_f0[c]) * pow5
            contrib = ((one - fres) * l_kd[c] + fres * spec_s) * (lw[3 + c] * lum)
            acc[c] = acc[c] + torch.where(hit, contrib.float(), 0.0)
        counter = counter + hit.float()

    # final = env_diffuse + env_specular + point + emission | sky
    out = [torch.where(mask, env_diff[c] + env_spec[c] + acc[c] + alb[c] * emission, sky[c])
           for c in range(3)]
    return torch.stack(out + [counter], 1)


# ------------------------------------------------------------- the pass ----
@functools.lru_cache(maxsize=64)
def _host_consts(device: torch.device, fov: float, ratio: float, near: float, far: float,
                 y_offset, fw: int, fh: int):
    """The host-known rows of kernel D's `const`: [tan(fov / 2), ratio, near,
    far], [y_offset] and [fw, fh, log(far / near), far / near], each a
    float32 tensor on `device`, uploaded once per value and then reused, so a
    frame makes no host-to-device copy for them."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor([math.tan(fov / 2.0), ratio, near, far], **f32),
            torch.tensor([y_offset], **f32),
            torch.tensor([fw, fh, math.log(far / near), far / near], **f32))


def deferred_shade_fused(gb_tiles, z_tiles, id_tiles, sh_pack, env_atlas, active_lights,
                         inv_view, camera_pos, env_ids: tuple, fov: float, ratio: float,
                         near: float, far: float, width: int, height: int, tile_h: int,
                         tile_w: int, y_offset=0, full_height: int | None = None,
                         full_width: int | None = None, env_budget: int | None = None,
                         light_dtype: str | None = None):
    """Fused deferred shading on tile blocks: gb_tiles (tiles, 9, blocks,
    128) quantized G-buffer, z_tiles/id_tiles (tiles, p, 1) raster blocks
    (inf / -1 on background) -> ((H, W, 3) HDR RT, env_approx_count () int32).
    `light_dtype`: the light loop's instance (LIGHT_DTYPES)."""
    fh = full_height if full_height is not None else height
    fw = full_width if full_width is not None else width
    n_tiles, _, blocks, _ = gb_tiles.shape
    tiles_x = width // tile_w
    if tuple(z_tiles.shape) != (n_tiles, tile_h * tile_w, 1):
        raise ValueError(f"z_tiles {tuple(z_tiles.shape)} do not match {n_tiles} "
                         f"{tile_h}x{tile_w} tiles")
    dev = gb_tiles.device
    depth_t = z_tiles.reshape(n_tiles, blocks, 128)
    depth_t = torch.where(torch.isinf(depth_t), 1.0, depth_t)
    mask_t = id_tiles.reshape(n_tiles, blocks, 128) >= 0

    # tiled per-pixel geometry (shading.pixel_view_geometry's formulas)
    wb = tile_w // 128
    tidx = torch.arange(n_tiles, device=dev)[:, None, None]
    bidx = torch.arange(blocks, device=dev)[None, :, None]
    lane = torch.arange(128, device=dev)[None, None, :]
    ox = ((tidx % tiles_x) * tile_w).float()
    oy = ((tidx // tiles_x) * tile_h).float()
    px = ((bidx % wb) * 128 + lane).float() + 0.5 + ox
    py = (bidx // wb).float() + 0.5 + oy + y_offset
    u = px / fw
    v = (py / fh).expand(u.shape)
    near_h = 2.0 * near * math.tan(fov / 2.0)
    near_w = near_h * ratio
    cam = torch.stack([(u - 0.5) * near_w, (0.5 - v) * near_h, torch.full_like(u, near)], -1)
    cam_vec = (cam[..., None, :] * inv_view[:3, :3]).sum(-1)
    z_view = near * far / (far - depth_t * (far - near))
    position = camera_pos + cam_vec * (z_view / near)[..., None]
    view_dir = common.normalize(camera_pos - position, 1e-20)
    normal = common.decode_octahedron(torch.stack([gb_tiles[:, 4], gb_tiles[:, 5]], -1))
    n_dot_v = torch.clamp((normal * view_dir).sum(-1), min=0.0)
    refl = common.normalize(2.0 * (normal * view_dir).sum(-1, keepdim=True) * normal - view_dir,
                            1e-20)
    ray = common.normalize(cam_vec, 1e-20)

    # the env cache's plan: tap groups, covers (kernel B), staged pages
    trace.begin("shade.env_plan")
    (off_arr, cnts, staged, rec_t, fx_t, fy_t, covered_t, env_approx, fracm,
     has_env) = envcache.env_plan(env_atlas, refl, ray, gb_tiles[:, 6], n_dot_v, mask_t, env_ids,
                                  stage_budget=env_budget)
    trace.end("shade.env_plan")

    cov0 = covered_t[:, 0].float()
    cov4 = covered_t[:, 4].float() if has_env else torch.zeros_like(cov0)
    gbk = torch.cat([gb_tiles[:, 0:4], normal.permute(0, 3, 1, 2), gb_tiles[:, 6:8],
                     z_view[:, None], mask_t.float()[:, None], fracm.permute(0, 3, 1, 2),
                     cov0[:, None], cov4[:, None]], 1)
    n_active = (active_lights[:, 13] > 0.0).sum().float()
    lens, yoff, proj = _host_consts(dev, fov, ratio, near, far, y_offset, fw, fh)
    const = torch.cat([
        lens,
        camera_pos.float().reshape(3),
        yoff,
        inv_view[:3, :3].reshape(9).float(),
        proj,
        n_active.reshape(1),
        torch.zeros(2, dtype=torch.float32, device=dev),
        sh_pack.reshape(28).float(),
        torch.zeros(12, dtype=torch.float32, device=dev),
    ])
    out = deferred_kernel(const, active_lights, off_arr, cnts, staged, rec_t, fx_t, fy_t,
                          gbk, has_env=has_env, tile_h=tile_h, tile_w=tile_w, tiles_x=tiles_x,
                          light_dtype=light_dtype)
    img = _untile(out, height, width, tile_h, tile_w)          # (4, H, W)
    return img[:3].permute(1, 2, 0).contiguous(), env_approx
