"""Tile-clustered point lights — counterpart of `ops/lights_pallas.py`
(kernel G), the 1024-light operating point.

The reference sizes its clustered pipeline for at most 1024 scene lights and
at most 32 per cluster (DeferredPipeline.h:326-330). The dense sweep in
`ops/shading.py` walks every active light over the whole frame; this path
walks only the lights that can touch a screen tile:

1. `tile_light_lists` culls each light's culling sphere against the tile's
   cluster-column union AABB (view space, closed form) and lists the hits in
   ascending light order, so the per-cluster cap of 32 admits the same
   lights as the dense sweep's serial counter;
2. `point_lights_tiled` stages each tile's listed light rows (lights on
   lanes, `stage_light_rows`), the tile's G-buffer (`tile_gbuffer`) and a
   32-float const vector (`light_constants`), runs kernel G and untiles its
   output (`untile`).

`point_lights_kernel` launches the hand-written CUDA kernel
`csrc/point_lights.cu` for CUDA tensors; for CPU tensors it runs
`point_lights_kernel_reference`, the plain PyTorch version, which follows
the TPU kernel op for op, 128-light chunk sums included. There is no
fallback between the two: a CUDA input either launches the kernel or raises.
The CUDA kernel builds one admitted list per distinct cluster and shades
only the admitted lights; `cluster_light_lists_reference` is the plain
version of those lists (the tests and `chip_smoke.py`'s census use it).
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import torch

from ..config import CLUSTER_X, CLUSTER_Y, CLUSTER_Z, MAX_LIGHTS_PER_CLUSTER
from ..kernels.launch import Entry

CHUNK = 128      # lights per staged chunk (the TPU kernel's lane width)
ROW_LEN = 16     # staged light row: the 14 active-light columns + 2 zero
GB_CH = 12       # [albedo(3), normal(3), roughness, metallic, z_view, mask, pad(2)]
CONST_LEN = 32
MAX_CAP = 65536  # the kernel keeps admitted list positions as uint16
_EPS = 1e-6
_INV_PI = 0.31830988618
_PI = 3.14159265359
_LAUNCH = Entry("point_lights", "point_lights_launch", "ppppiiiiip")


def tile_light_lists(rows, tiles_y: int, tiles_x: int, tile_h: int, tile_w: int,
                     full_width: int, full_height: int, fov: float, ratio: float, near: float,
                     far: float, cap: int, y_offset=0):
    """rows (N, 14) active-light rows -> (ids (tiles, cap) int32, ascending
    with -1 pads, counts (tiles,) int32). A light is listed when its culling
    sphere (view space, radius rows[:, 13]) meets the tile's cluster-column
    union AABB: the tile's cluster (x, y) index range at pixel centers, z
    spanning [near, far]. The test is inflated (* 1.0002 + 1e-5) so that a
    light the per-pixel test could admit is never left out; counts > cap
    mean truncation (the pipeline reports it)."""
    n = rows.shape[0]
    dev = rows.device
    pos_view = rows[:, 10:13]
    cull_r = rows[:, 13]

    # tile -> cluster index ranges (pixel centers)
    tx0 = (torch.arange(tiles_x, device=dev) * tile_w).float()
    ty0 = (torch.arange(tiles_y, device=dev) * tile_h).float() + y_offset
    u_lo = (tx0 + 0.5) / full_width
    u_hi = (tx0 + tile_w - 0.5) / full_width
    v_lo = (ty0 + 0.5) / full_height
    v_hi = (ty0 + tile_h - 0.5) / full_height
    sx_lo = torch.clamp(torch.floor(u_lo * CLUSTER_X), 0, CLUSTER_X - 1)
    sx_hi = torch.clamp(torch.floor(u_hi * CLUSTER_X), 0, CLUSTER_X - 1)
    # sy = floor((1 - v) * Y): v_hi gives the low cluster row
    sy_lo = torch.clamp(torch.floor((1.0 - v_hi) * CLUSTER_Y), 0, CLUSTER_Y - 1)
    sy_hi = torch.clamp(torch.floor((1.0 - v_lo) * CLUSTER_Y), 0, CLUSTER_Y - 1)

    tan_half = math.tan(fov / 2.0)
    kx, ky = ratio * tan_half, tan_half
    nx_lo = 2.0 * sx_lo / CLUSTER_X - 1.0            # (tiles_x,)
    nx_hi = 2.0 * (sx_hi + 1) / CLUSTER_X - 1.0
    ny_lo = 2.0 * sy_lo / CLUSTER_Y - 1.0            # (tiles_y,)
    ny_hi = 2.0 * (sy_hi + 1) / CLUSTER_Y - 1.0

    def span(lo, hi, k):
        return (torch.minimum(lo * k * near, lo * k * far),
                torch.maximum(hi * k * near, hi * k * far))

    xmin, xmax = span(nx_lo, nx_hi, kx)
    ymin, ymax = span(ny_lo, ny_hi, ky)
    xmin_t = xmin.repeat(tiles_y)[:, None]           # (tiles, 1)
    xmax_t = xmax.repeat(tiles_y)[:, None]
    ymin_t = ymin.repeat_interleave(tiles_x)[:, None]
    ymax_t = ymax.repeat_interleave(tiles_x)[:, None]

    px, py, pz = pos_view[None, :, 0], pos_view[None, :, 1], pos_view[None, :, 2]
    dx = px - torch.minimum(torch.maximum(px, xmin_t), xmax_t)
    dy = py - torch.minimum(torch.maximum(py, ymin_t), ymax_t)
    dz = pz - torch.clamp(pz, near, far)
    d2 = dx * dx + dy * dy + dz * dz
    hit = d2 < (cull_r * cull_r)[None, :] * 1.0002 + 1e-5

    counts = hit.sum(1, dtype=torch.int32)
    # id scores n - i keep the top-k in ascending light order
    score = torch.where(hit, n - torch.arange(n, dtype=torch.int32, device=dev)[None, :], 0)
    if n < cap:
        score = torch.nn.functional.pad(score, (0, cap - n))
    top = torch.topk(score, cap, dim=1).values
    ids = torch.where(top > 0, n - top, -1).to(torch.int32)
    return ids, counts


# ------------------------------------------------------------- kernel G ----
def point_lights_kernel(counts, const, rows_t, gb_t, *, tile_h: int, tile_w: int, tiles_x: int):
    """Kernel G on one frame's tiles. counts (tiles,) int32 listed lights
    (already clamped to cap); const (32,) f32 [tan_half, ratio, near, far,
    cam(3), yoff, R(9) row-major inv_view[:3,:3], fw, fh, log(far/near),
    far/near, pad(11)]; rows_t (tiles, 16, cap) f32 light rows, lights on
    lanes; gb_t (tiles, p, 12) f32. -> (tiles, p, 4) f32 [rgb * mask, hit
    counter]."""
    if gb_t.device.type == "cpu":
        return point_lights_kernel_reference(counts, const, rows_t, gb_t, tile_h=tile_h,
                                             tile_w=tile_w, tiles_x=tiles_x)
    if gb_t.device.type != "cuda":
        raise ValueError(f"point_lights_kernel: unsupported device {gb_t.device}")
    tiles, p, ch = gb_t.shape
    cap = rows_t.shape[-1]
    if p != tile_h * tile_w or ch != GB_CH or tiles % tiles_x:
        raise ValueError(f"gb_t must be (tiles, {tile_h * tile_w}, {GB_CH}) over whole rows "
                         f"of {tiles_x} tiles, got {tuple(gb_t.shape)}")
    if cap % CHUNK or not CHUNK <= cap <= MAX_CAP:
        raise ValueError(f"the light cap must be a multiple of {CHUNK} in {CHUNK}..{MAX_CAP}, "
                         f"got {cap}")
    shapes = {"counts": (counts, (tiles,), torch.int32),
              "const": (const, (CONST_LEN,), torch.float32),
              "rows_t": (rows_t, (tiles, ROW_LEN, cap), torch.float32),
              "gb_t": (gb_t, (tiles, p, GB_CH), torch.float32)}
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != gb_t.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {gb_t.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    c = [x.contiguous() for x in (counts, const, rows_t, gb_t)]
    if c[3].data_ptr() % 16:   # the kernel reads each pixel's 12 floats as 3 float4
        c[3] = c[3].clone()
    dev = gb_t.device
    out = torch.empty((tiles, p, 4), dtype=torch.float32, device=dev)
    _LAUNCH(dev, c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(), c[3].data_ptr(), tiles, cap,
            tile_h, tile_w, tiles_x, out.data_ptr())
    return out


# ------------------------------------------------------- plain version ----
_PLAIN_BATCH = 1 << 26   # (tiles x pixels x 128 lights) per batch: bounds memory


def point_lights_kernel_reference(counts, const, rows_t, gb_t, *, tile_h: int, tile_w: int,
                                  tiles_x: int):
    """Plain PyTorch version of kernel G: the TPU kernel's formulas in its
    order on (pixels, 128-light) grids, one chunk of 128 staged lights at a
    time, the cap-32 counter through an exclusive prefix sum over the
    chunk's lanes, each chunk's contribution summed over its lanes and then
    added to the running sums. Tiles go in batches to bound memory."""
    tiles, p, _ = gb_t.shape
    per = max(1, _PLAIN_BATCH // (p * CHUNK))
    return torch.cat([
        _reference_tiles(counts[s:s + per], const, rows_t[s:s + per], gb_t[s:s + per], s,
                         tile_h=tile_h, tile_w=tile_w, tiles_x=tiles_x)
        for s in range(0, tiles, per)])


def _cluster_aabb(const, sx, sy, szf):
    """A cluster's view-space AABB in closed form from its indices (sx, sy,
    szf), the kernel's expressions in its order: (cminx, cmaxx, cminy,
    cmaxy, znear_c, zfar_c), shaped as the indices."""
    tan_half, ratio, near, fn_ratio = const[0], const[1], const[2], const[20]
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
    return (torch.minimum(torch.minimum(xa, xb), torch.minimum(xc, xd)),
            torch.maximum(torch.maximum(xa, xb), torch.maximum(xc, xd)),
            torch.minimum(torch.minimum(ya, yb), torch.minimum(yc, yd)),
            torch.maximum(torch.maximum(ya, yb), torch.maximum(yc, yd)),
            znear_c, zfar_c)


def _sphere_hits(aabb, pvx, pvy, pvz, cull):
    """The cluster sphere test: a light's culling sphere (view-space center,
    radius) meets the cluster AABB."""
    cminx, cmaxx, cminy, cmaxy, znear_c, zfar_c = aabb
    dx = pvx - torch.minimum(torch.maximum(pvx, cminx), cmaxx)
    dy = pvy - torch.minimum(torch.maximum(pvy, cminy), cmaxy)
    dz = pvz - torch.minimum(torch.maximum(pvz, znear_c), zfar_c)
    return (dx * dx + dy * dy + dz * dz) < cull * cull


def _pixel_setup(const, gb_t, first: int, *, tile_h, tile_w, tiles_x):
    """Kernel G's per-pixel setup on tiles first.. of gb_t (n_t, p, 12):
    world position, view vector, material terms, cluster indices (sx, sy,
    szf) and cluster AABB, each (n_t, p, 1)."""
    n_t, p, _ = gb_t.shape
    dev = gb_t.device
    tan_half, ratio, near, far = const[0], const[1], const[2], const[3]
    camx, camy, camz = const[4], const[5], const[6]
    yoff, width, full_h = const[7], const[17], const[18]
    log_zr = const[19]

    t = torch.arange(first, first + n_t, device=dev)[:, None, None]
    lin = torch.arange(p, device=dev)[None, :, None]
    ox = (t % tiles_x) * tile_w
    oy = (t // tiles_x) * tile_h
    px = (lin % tile_w).float() + 0.5 + ox
    py = (lin // tile_w).float() + 0.5 + oy + yoff

    def ch(c):
        return gb_t[:, :, c:c + 1]                    # (n_t, p, 1)

    s = SimpleNamespace(alb=(ch(0), ch(1), ch(2)), nx=ch(3), ny=ch(4), nz=ch(5),
                        mask=ch(9) > 0.5)
    rough, metal, z_view = ch(6), ch(7), ch(8)

    # world position: cam + R @ ((u-.5)nw, (.5-v)nh, near) * z_view/near
    u = px / width
    v = py / full_h
    near_h = 2.0 * near * tan_half
    near_w = near_h * ratio
    cx_ = (u - 0.5) * near_w
    cy_ = (0.5 - v) * near_h
    scale = z_view / near
    s.posx = camx + (const[8] * cx_ + const[9] * cy_ + const[10] * near) * scale
    s.posy = camy + (const[11] * cx_ + const[12] * cy_ + const[13] * near) * scale
    s.posz = camz + (const[14] * cx_ + const[15] * cy_ + const[16] * near) * scale
    vdx, vdy, vdz = camx - s.posx, camy - s.posy, camz - s.posz
    # 1 / sqrt, both correctly rounded, as the CUDA kernel computes it (the
    # TPU kernel's rsqrt is within an ulp of it)
    inv_vl = 1.0 / torch.sqrt(torch.clamp(vdx * vdx + vdy * vdy + vdz * vdz, min=1e-40))
    s.vdx, s.vdy, s.vdz = vdx * inv_vl, vdy * inv_vl, vdz * inv_vl
    s.n_dot_v = torch.clamp(s.nx * s.vdx + s.ny * s.vdy + s.nz * s.vdz, min=0.0)

    # per-pixel cluster indices and AABB (view space, closed form)
    s.sx = torch.clamp(torch.floor(u * CLUSTER_X), 0, CLUSTER_X - 1)
    s.sy = torch.clamp(torch.floor((1.0 - v) * CLUSTER_Y), 0, CLUSTER_Y - 1)
    zc_ = torch.minimum(torch.maximum(z_view, near), far)
    s.szf = torch.clamp(torch.floor(CLUSTER_Z * torch.log(zc_ / near) / log_zr), 0,
                        CLUSTER_Z - 1)
    s.aabb = _cluster_aabb(const, s.sx, s.sy, s.szf)

    # material precomputes
    s.f0 = [0.04 * (1.0 - metal) + a * metal for a in s.alb]
    s.kd_alb = [a * (1.0 - metal) * _INV_PI for a in s.alb]
    a_r = rough * rough
    s.a2 = a_r * a_r
    s.k_geo = (rough + 1.0) * (rough + 1.0) * (1.0 / 8.0)
    s.g_v = s.n_dot_v / torch.clamp(s.n_dot_v * (1.0 - s.k_geo) + s.k_geo, min=_EPS)
    return s


def _light_terms(s, lp):
    """The Cook-Torrance terms of lights lp (columns 0..9 of the light rows,
    each broadcastable against the pixels of `s`): (lum, [f_c] * 3), a
    light's contribution to channel c being f_c[c] * (color[c] * lum)."""
    ldx, ldy, ldz = lp[0] - s.posx, lp[1] - s.posy, lp[2] - s.posz
    dist = torch.sqrt(ldx * ldx + ldy * ldy + ldz * ldz)
    inv_d = 1.0 / torch.clamp(dist, min=1e-20)
    ldx, ldy, ldz = ldx * inv_d, ldy * inv_d, ldz * inv_d
    n_dot_l = torch.clamp(s.nx * ldx + s.ny * ldy + s.nz * ldz, min=0.0)
    hx, hy, hz = ldx + s.vdx, ldy + s.vdy, ldz + s.vdz
    inv_h = 1.0 / torch.clamp(torch.sqrt(hx * hx + hy * hy + hz * hz), min=_EPS)
    n_dot_h = torch.clamp((s.nx * hx + s.ny * hy + s.nz * hz) * inv_h, min=0.0)
    t_ = n_dot_h * n_dot_h * (s.a2 - 1.0) + 1.0
    d_ggx = s.a2 / torch.clamp(_PI * t_ * t_, min=_EPS)
    g_l = n_dot_l / torch.clamp(n_dot_l * (1.0 - s.k_geo) + s.k_geo, min=_EPS)
    g_smith = s.g_v * g_l
    spec_s = d_ggx * g_smith / torch.clamp(4.0 * n_dot_l * s.n_dot_v, min=1e-4)
    one_m = torch.clamp(1.0 - n_dot_l, min=_EPS)
    om2 = one_m * one_m
    pow5 = om2 * om2 * one_m
    att = 1.0 / torch.clamp(lp[7] + lp[8] * dist + lp[9] * (dist * dist), min=_EPS)
    lum = lp[6] * att * n_dot_l
    f_c = []
    for k in range(3):
        fres = s.f0[k] + (1.0 - s.f0[k]) * pow5
        f_c.append((1.0 - fres) * s.kd_alb[k] + fres * spec_s)
    return lum, f_c


def _reference_tiles(counts, const, rows_t, gb_t, first: int, *, tile_h, tile_w, tiles_x):
    n_t = gb_t.shape[0]
    cap = rows_t.shape[-1]
    dev = gb_t.device
    s = _pixel_setup(const, gb_t, first, tile_h=tile_h, tile_w=tile_w, tiles_x=tiles_x)

    n_chunks = (torch.clamp(counts, max=cap) + CHUNK - 1) // CHUNK
    tri = (torch.arange(CHUNK, device=dev)[:, None]
           < torch.arange(CHUNK, device=dev)[None, :]).float()
    acc = [torch.zeros_like(s.n_dot_v) for _ in range(3)]
    counter = torch.zeros_like(s.n_dot_v)
    for c in range(int(n_chunks.max()) if n_t else 0):
        live = (c < n_chunks)[:, None, None]          # the tile's loop runs chunk c
        lp = rows_t[:, :, c * CHUNK:(c + 1) * CHUNK][:, :, None, :]   # (n_t, 16, 1, CHUNK)
        lp = lp.unbind(1)

        # cluster sphere test (pixel x light)
        raw = _sphere_hits(s.aabb, *lp[10:14])                      # (n_t, p, CHUNK)
        excl = raw.float() @ tri                                    # exclusive lane prefix sum
        ok = raw & (counter + excl < float(MAX_LIGHTS_PER_CLUSTER))

        lum, f_c = _light_terms(s, lp)
        okf = torch.where(ok, lum, 0.0)
        for k in range(3):
            acc[k] = torch.where(live, acc[k] + (f_c[k] * (lp[3 + k] * okf)).sum(-1, keepdim=True),
                                 acc[k])
        counter = torch.where(live, counter + ok.float().sum(-1, keepdim=True), counter)

    maskf = s.mask.float()
    return torch.cat([acc[0] * maskf, acc[1] * maskf, acc[2] * maskf, counter], -1)


# ----------------------------------------------- the kernel's cluster lists ----
_NAN_SLICE = CLUSTER_Z   # the key's slice for a NaN depth: its AABB is NaN, it admits nothing
KEYS_PER_TILE = CLUSTER_X * CLUSTER_Y * (CLUSTER_Z + 1)


def pixel_cluster_keys(const, gb_t, *, tile_h: int, tile_w: int, tiles_x: int):
    """(tiles, p) int64 cluster key of every pixel within its tile, sx + 24
    (sy + 16 szf): the CUDA kernel's grouping (it packs szf's bits instead;
    a NaN slice gets key slice 8 here)."""
    s = _pixel_setup(const, gb_t, 0, tile_h=tile_h, tile_w=tile_w, tiles_x=tiles_x)
    szf = torch.where(torch.isnan(s.szf), float(_NAN_SLICE), s.szf)
    return (s.sx + CLUSTER_X * (s.sy + CLUSTER_Y * szf))[..., 0].long()


def cluster_light_lists_reference(counts, const, rows_t, gb_t, *, tile_h: int, tile_w: int,
                                  tiles_x: int, batch: int = 1 << 22):
    """Plain version of the CUDA kernel's admitted lists (step 2 of its
    design). One list per distinct (tile, cluster): the cluster's AABB from
    its indices, the sphere test against the first min(counts, cap) entries
    of the tile's list, and the first 32 hits kept. -> (positions (tiles, p,
    32) int32, each pixel's admitted list positions ascending, -1 padded;
    count (tiles, p) int32). Clusters go in batches of `batch` tests."""
    tiles, p, _ = gb_t.shape
    cap = rows_t.shape[-1]
    dev = gb_t.device
    key = (torch.arange(tiles, device=dev)[:, None] * KEYS_PER_TILE
           + pixel_cluster_keys(const, gb_t, tile_h=tile_h, tile_w=tile_w, tiles_x=tiles_x))
    uniq, inv = torch.unique(key, return_inverse=True)
    tile_of, local = uniq // KEYS_PER_TILE, uniq % KEYS_PER_TILE
    sx = (local % CLUSTER_X).float()
    sy = (local // CLUSTER_X % CLUSTER_Y).float()
    szf = (local // (CLUSTER_X * CLUSTER_Y)).float()
    szf = torch.where(szf == _NAN_SLICE, float("nan"), szf)
    listed = torch.clamp(counts, max=cap)[tile_of]
    lane = torch.arange(cap, device=dev)
    pos_u, n_u = [], []
    step = max(1, batch // cap)
    for b in range(0, uniq.numel(), step):
        sl = slice(b, b + step)
        aabb = _cluster_aabb(const, sx[sl, None], sy[sl, None], szf[sl, None])  # each (n, 1)
        lp = rows_t[:, 10:14][tile_of[sl]]                         # (n, 4, cap)
        hit = _sphere_hits(aabb, *lp.unbind(1))
        hit = hit & (lane[None, :] < listed[sl, None])
        adm = hit & (torch.cumsum(hit, 1) <= MAX_LIGHTS_PER_CLUSTER)
        first = torch.sort(torch.where(adm, lane, cap), 1).values[:, :MAX_LIGHTS_PER_CLUSTER]
        pos_u.append(torch.where(first < cap, first, -1).to(torch.int32))
        n_u.append(adm.sum(1, dtype=torch.int32))
    if not pos_u:
        return (torch.full((tiles, p, MAX_LIGHTS_PER_CLUSTER), -1, dtype=torch.int32,
                           device=dev), torch.zeros((tiles, p), dtype=torch.int32, device=dev))
    return torch.cat(pos_u)[inv], torch.cat(n_u)[inv]


# ------------------------------------------------------------- the pass ----
def stage_light_rows(rows, ids):
    """Per-tile light rows, lights on lanes: rows (N, 14), ids (tiles, cap)
    -> (tiles, 16, cap); -1 pads get a zero row (cull_r = 0 never hits)."""
    rows16 = torch.cat([rows, torch.zeros((rows.shape[0], ROW_LEN - 14), dtype=rows.dtype,
                                          device=rows.device)], 1)
    g = torch.where((ids >= 0)[..., None], rows16[torch.clamp(ids, min=0).long()], 0.0)
    return g.transpose(1, 2).contiguous()


def tile_gbuffer(albedo, normal, roughness, metallic, z_view, mask, tile_h: int, tile_w: int):
    """The pass's per-pixel inputs (H, W[, 3]) -> gb_t (tiles, p, 12)."""
    height, width = z_view.shape
    tiles_y, tiles_x = height // tile_h, width // tile_w
    zero = torch.zeros_like(roughness)
    gb = torch.stack([albedo[..., 0], albedo[..., 1], albedo[..., 2], normal[..., 0],
                      normal[..., 1], normal[..., 2], roughness, metallic, z_view,
                      mask.float(), zero, zero], -1)                  # (H, W, 12)
    return (gb.reshape(tiles_y, tile_h, tiles_x, tile_w, GB_CH).permute(0, 2, 1, 3, 4)
            .reshape(tiles_y * tiles_x, tile_h * tile_w, GB_CH).contiguous())


@functools.lru_cache(maxsize=None)
def _constant_rows(fov: float, ratio: float, near: float, far: float, full_width: int,
                   full_height: int, y_offset: int, device: torch.device):
    """`light_constants`' rows that do not change from frame to frame: f64
    host constants rounded to f32, uploaded once per key and then reused (a
    frame makes no host-to-device copy for them)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor([math.tan(fov / 2.0), ratio, near, far], **f32),
            torch.tensor([y_offset], **f32),
            torch.cat([torch.tensor([full_width, full_height, math.log(far / near),
                                     far / near], **f32), torch.zeros(11, **f32)]))


def light_constants(inv_view, camera_pos, fov: float, ratio: float, near: float, far: float,
                    full_width: int, full_height: int, y_offset=0):
    """Kernel G's (32,) const vector; f64 host constants rounded to f32, as
    the JAX package builds them, around this frame's camera position and
    rotation."""
    head, yoff, tail = _constant_rows(fov, ratio, near, far, full_width, full_height,
                                      y_offset, inv_view.device)
    return torch.cat([head, camera_pos.float().reshape(3), yoff,
                      inv_view[:3, :3].reshape(9).float(), tail])


def untile(out, tiles_y: int, tiles_x: int, tile_h: int, tile_w: int):
    """Kernel G's (tiles, p, 4) output -> (H, W, 4)."""
    return (out.reshape(tiles_y, tiles_x, tile_h, tile_w, 4).permute(0, 2, 1, 3, 4)
            .reshape(tiles_y * tile_h, tiles_x * tile_w, 4))


def point_lights_tiled(rows, albedo, normal, roughness, metallic, z_view, mask, inv_view,
                       camera_pos, fov: float, ratio: float, near: float, far: float,
                       width: int, height: int, tile_h: int = 24, tile_w: int = 128,
                       y_offset=0, full_height: int | None = None,
                       full_width: int | None = None, cap: int = 256):
    """Clustered point-light accumulation -> ((H, W, 3) rgb, counts (tiles,)
    int32 per-tile listed lights; counts > cap is truncation). Same cluster
    membership, light order and cap-32 counter as the dense sweep in
    ops/shading.py, to float32 re-association; cost O(lights per tile)."""
    done = {}
    for name, step in point_lights_steps(rows, albedo, normal, roughness, metallic, z_view,
                                         mask, inv_view, camera_pos, fov, ratio, near, far,
                                         width, height, tile_h, tile_w, y_offset, full_height,
                                         full_width, cap):
        done[name] = step(done)
    return done["untiling"], done["lists"][1]


def point_lights_steps(rows, albedo, normal, roughness, metallic, z_view, mask, inv_view,
                       camera_pos, fov: float, ratio: float, near: float, far: float,
                       width: int, height: int, tile_h: int = 24, tile_w: int = 128,
                       y_offset=0, full_height: int | None = None,
                       full_width: int | None = None, cap: int = 256):
    """`point_lights_tiled`'s steps in the order it runs them: a list of
    (name, step), where step(done) takes the results of the earlier steps by
    name and returns its own. Kept apart so that each step can be timed on
    its own on the inputs the pass gives it."""
    fh = full_height if full_height is not None else height
    fw = full_width if full_width is not None else width
    tiles_y, tiles_x = height // tile_h, width // tile_w
    if cap % CHUNK:
        raise ValueError(f"light cap {cap} is not a multiple of {CHUNK}")
    return [
        ("lists", lambda d: tile_light_lists(rows, tiles_y, tiles_x, tile_h, tile_w, fw, fh,
                                             fov, ratio, near, far, cap, y_offset=y_offset)),
        ("row staging", lambda d: stage_light_rows(rows, d["lists"][0])),
        ("G-buffer tiling", lambda d: tile_gbuffer(albedo, normal, roughness, metallic, z_view,
                                                   mask, tile_h, tile_w)),
        ("constants", lambda d: light_constants(inv_view, camera_pos, fov, ratio, near, far,
                                                fw, fh, y_offset)),
        ("kernel", lambda d: point_lights_kernel(
            torch.clamp(d["lists"][1], max=cap), d["constants"], d["row staging"],
            d["G-buffer tiling"], tile_h=tile_h, tile_w=tile_w, tiles_x=tiles_x)),
        ("untiling", lambda d: untile(d["kernel"], tiles_y, tiles_x, tile_h, tile_w)[..., :3]),
    ]
