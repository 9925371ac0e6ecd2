"""Tile-based triangle rasterizer — counterpart of `ops/raster.py`.

Vertex stage, clipless homogeneous triangle setup (Olano-Greer), per-tile
binning in draw order, and the plain chunked depth fold that the
`use_pallas=False` path runs. Same formulas, tie rules and layouts as the
JAX package (see its module docstring for the documented quirks vs the D3D
hardware rasterizer).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TriangleSetup(NamedTuple):
    """Homogeneous (clipless) triangle setup — see the JAX twin."""

    xy: torch.Tensor        # (T, 3, 2) screen positions (garbage where w<=eps)
    z: torch.Tensor         # (T, 3) CLIP z (= ndc_z * w)
    w_clip: torch.Tensor    # (T, 3) clip w
    edges: torch.Tensor     # (T, 3, 3) homogeneous edge rows
    aabb: torch.Tensor      # (T, 4) xmin, ymin, xmax, ymax (pixels, conservative)
    valid: torch.Tensor     # (T,) bool


class Bins(NamedTuple):
    ids: torch.Tensor       # (num_tiles, cap) int32 triangle ids (draw order), -1 pad
    counts: torch.Tensor    # (num_tiles,) int32 (pre-clamp counts; > cap = overflow)


def vertex_transform(positions, instance_ids, model_mats, view_proj):
    """positions (V, 3), instance_ids (V,), model_mats (I, 4, 4) -> clip (V, 4).
    Column-vector convention (clip = P*V*M*pos), gbuffer.hlsl:75-83."""
    m = model_mats[instance_ids.long()]
    ph = torch.cat([positions, torch.ones_like(positions[..., :1])], dim=-1)
    world = (m * ph[:, None, :]).sum(-1)
    return (view_proj[None, :, :] * world[:, None, :]).sum(-1)


def transform_directions(dirs, instance_ids, normal_mats):
    """Normals/tangents via transpose(inverse(M)) (gbuffer.hlsl:77-79)."""
    m = normal_mats[instance_ids.long()]
    return (m * dirs[:, None, :]).sum(-1)


def setup_triangles(verts_clip, tris, tri_valid, width: int, height: int,
                    w_eps: float = 1e-4) -> TriangleSetup:
    v = verts_clip[tris.long()]  # (T, 3, 4)
    w = v[..., 3]
    z = v[..., 2]
    in_front = w > w_eps

    inv_w = 1.0 / torch.where(in_front, w, 1.0)
    x = (v[..., 0] * inv_w * 0.5 + 0.5) * width
    y = (1.0 - (v[..., 1] * inv_w * 0.5 + 0.5)) * height
    xy = torch.stack([x, y], -1)

    # viewport-scaled homogeneous coords anchored at the first in-front
    # vertex's projection (cancellation-free cross products)
    ax = torch.where(in_front[:, 0], x[:, 0], torch.where(in_front[:, 1], x[:, 1], x[:, 2]))
    ay = torch.where(in_front[:, 0], y[:, 0], torch.where(in_front[:, 1], y[:, 1], y[:, 2]))
    hx, hy = 0.5 * width, 0.5 * height
    vx = v[..., 0] * hx + (hx - ax[:, None]) * w
    vy = -(v[..., 1] * hy) + (hy - ay[:, None]) * w

    def cross(j, k):
        return torch.stack(
            [
                vy[:, j] * w[:, k] - vy[:, k] * w[:, j],
                w[:, j] * vx[:, k] - w[:, k] * vx[:, j],
                vx[:, j] * vy[:, k] - vx[:, k] * vy[:, j],
            ],
            -1,
        )

    b0, b1, b2 = cross(1, 2), cross(2, 0), cross(0, 1)
    det = b0[:, 0] * vx[:, 0] + b0[:, 1] * vy[:, 0] + b0[:, 2] * w[:, 0]
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    edges = torch.stack([b0, b1, b2], 1) * inv_det[:, None, None]
    # translate evaluation from anchored coords to pixel coords
    c = edges[:, :, 2] + -(edges[:, :, 0] * ax[:, None] + edges[:, :, 1] * ay[:, None])
    edges = torch.cat([edges[:, :, :2], c[:, :, None]], dim=2)

    # conservative screen AABB: in-front vertex projections plus the
    # projections of the w = eps crossing points of sign-changing edges
    big = 3e38
    xmin = torch.where(in_front, x, big).amin(-1)
    xmax = torch.where(in_front, x, -big).amax(-1)
    ymin = torch.where(in_front, y, big).amin(-1)
    ymax = torch.where(in_front, y, -big).amax(-1)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        crossing = in_front[:, a] != in_front[:, b]
        t = (w_eps - w[:, a]) / torch.where(w[:, b] == w[:, a], 1.0, w[:, b] - w[:, a])
        cx_h = v[:, a, 0] + t * (v[:, b, 0] - v[:, a, 0])
        cy_h = v[:, a, 1] + t * (v[:, b, 1] - v[:, a, 1])
        cx = (cx_h / w_eps * 0.5 + 0.5) * width
        cy = (1.0 - (cy_h / w_eps * 0.5 + 0.5)) * height
        xmin = torch.where(crossing, torch.minimum(xmin, cx), xmin)
        xmax = torch.where(crossing, torch.maximum(xmax, cx), xmax)
        ymin = torch.where(crossing, torch.minimum(ymin, cy), ymin)
        ymax = torch.where(crossing, torch.maximum(ymax, cy), ymax)

    aabb = torch.stack(
        [
            torch.clamp(torch.floor(xmin), 0, width),
            torch.clamp(torch.floor(ymin), 0, height),
            torch.clamp(torch.ceil(xmax), 0, width),
            torch.clamp(torch.ceil(ymax), 0, height),
        ],
        -1,
    )
    any_crossing = (in_front != in_front[:, :1]).any(-1)
    far_ok = (z <= w).any(-1) | any_crossing
    valid = (
        tri_valid
        & in_front.any(-1)
        & (det > 0)
        & (aabb[:, 2] > aabb[:, 0]) & (aabb[:, 3] > aabb[:, 1])
        & far_ok
    )
    return TriangleSetup(xy, z, w, edges, aabb, valid)


def _compact_by_id(overlap, ids, t: int, cap: int) -> torch.Tensor:
    """Per-row ascending-id compaction to `cap` slots (-1 pad): top-k over
    score = overlap ? T - id : 0 — descending score is ascending id, so each
    list keeps submission order (lax.top_k in the JAX package)."""
    score = torch.where(overlap, t - ids, 0).to(torch.int32)
    if score.shape[1] < cap:
        score = torch.nn.functional.pad(score, (0, cap - score.shape[1]))
    top = torch.topk(score, cap, dim=1).values
    return torch.where(top > 0, t - top, -1).to(torch.int32)


def bin_triangles(setup: TriangleSetup, tiles_y: int, tiles_x: int, tile_h: int,
                  tile_w: int, cap: int, y_offset=0) -> Bins:
    """Compact triangle ids into per-tile lists (stable draw order)."""
    num_tiles = tiles_y * tiles_x
    t = setup.aabb.shape[0]
    dev = setup.aabb.device
    tx0 = (torch.arange(tiles_x, device=dev) * tile_w).float()
    ty0 = (torch.arange(tiles_y, device=dev) * tile_h).float() + y_offset
    xmin, ymin, xmax, ymax = (setup.aabb[:, i] for i in range(4))
    ov_x = (xmin[None, :] < (tx0 + tile_w)[:, None]) & (xmax[None, :] > tx0[:, None])
    ov_y = (ymin[None, :] < (ty0 + tile_h)[:, None]) & (ymax[None, :] > ty0[:, None])
    overlap = (ov_y[:, None, :] & ov_x[None, :, :] & setup.valid[None, None, :]).reshape(
        num_tiles, t
    )
    counts = overlap.sum(dim=1).to(torch.int32)
    ids = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    return Bins(_compact_by_id(overlap, ids, t, cap), counts)


def bin_triangles_hier(setup: TriangleSetup, tiles_y: int, tiles_x: int, tile_h: int,
                       tile_w: int, cap: int, y_offset=0, super_h: int = 8,
                       super_w: int = 4, cap1: int = 16384) -> Bins:
    """Two-level binning for large triangle pools: supertiles compact their
    overlap sets to <= cap1 candidates, then each tile compacts over its
    supertile's candidates. Same output contract as bin_triangles.

    The JAX package's fine pass picks its width with a `lax.cond` on the
    realized density (the first cap1 // 4 candidate columns when every
    supertile holds that few). Both widths give the same bins: the columns
    past a supertile's count hold no valid candidate. Here the fine pass
    always takes all cap1 columns, so no host read decides it, and stays
    cheap at that width: a tile's overlap row is its supertile row's and
    supertile column's tests ANDed (no per-tile gather of candidate AABBs),
    and the candidates, ascending in each row, compact by their running
    count (a scatter, no top-k)."""
    num_tiles = tiles_y * tiles_x
    t = setup.aabb.shape[0]
    dev = setup.aabb.device
    cap1 = min(cap1, t)
    sy = -(-tiles_y // super_h)
    sx = -(-tiles_x // super_w)

    xmin, ymin, xmax, ymax = (setup.aabb[:, i] for i in range(4))
    sx0 = (torch.arange(sx, device=dev) * (super_w * tile_w)).float()
    sy0 = (torch.arange(sy, device=dev) * (super_h * tile_h)).float() + y_offset
    ov_x1 = (xmin[None, :] < (sx0 + super_w * tile_w)[:, None]) & (xmax[None, :] > sx0[:, None])
    ov_y1 = (ymin[None, :] < (sy0 + super_h * tile_h)[:, None]) & (ymax[None, :] > sy0[:, None])
    ov1 = (ov_y1[:, None, :] & ov_x1[None, :, :] & setup.valid[None, None, :]).reshape(sy * sx, t)
    cnt1 = ov1.sum(dim=1).to(torch.int32)
    score1 = torch.where(ov1, t - torch.arange(t, dtype=torch.int32, device=dev)[None, :], 0)
    top1 = torch.topk(score1.to(torch.int32), cap1, dim=1).values
    cand = torch.where(top1 > 0, t - top1, 0)                    # (S, cap1) ascending ids
    cand_valid = top1 > 0
    aabb_c = setup.aabb[cand.long()]                             # (S, cap1, 4)

    # each supertile's candidates against its super_w tile columns and its
    # super_h tile rows (tile edges as bin_triangles computes them)
    ty_s = torch.arange(sy * super_h, device=dev).reshape(sy, super_h)
    tx_s = torch.arange(sx * super_w, device=dev).reshape(sx, super_w)
    x0 = (tx_s * tile_w).float()[None, :, :, None]               # (1, sx, super_w, 1)
    y0 = (ty_s * tile_h).float()[:, None, :, None] + y_offset    # (sy, 1, super_h, 1)
    a = aabb_c.reshape(sy, sx, 1, cap1, 4)
    ov_x = ((a[..., 0] < x0 + tile_w) & (a[..., 2] > x0)).reshape(sy * sx, super_w, cap1)
    ov_y = ((a[..., 1] < y0 + tile_h) & (a[..., 3] > y0)).reshape(sy * sx, super_h, cap1)
    ty = torch.arange(tiles_y, device=dev)[:, None].expand(tiles_y, tiles_x).reshape(num_tiles)
    tx = torch.arange(tiles_x, device=dev)[None, :].expand(tiles_y, tiles_x).reshape(num_tiles)
    s_of_tile = (ty // super_h) * sx + tx // super_w
    ov2 = ov_y[s_of_tile, ty % super_h] & ov_x[s_of_tile, tx % super_w] & cand_valid[s_of_tile]
    counts = ov2.sum(dim=1).to(torch.int32)
    # supertile overflow surfaces as count > cap
    counts = torch.where((cnt1 > cap1)[s_of_tile], torch.clamp(counts, min=cap + 1), counts)
    # list position = running count; entries past cap land in a dropped column
    pos = torch.cumsum(ov2, dim=1, dtype=torch.int32) - 1
    keep = ov2 & (pos < cap)
    ids = torch.full((num_tiles, cap + 1), -1, dtype=torch.int32, device=dev)
    ids.scatter_(1, torch.where(keep, pos, cap).long(), torch.where(keep, cand[s_of_tile], -1))
    return Bins(ids[:, :cap].contiguous(), counts)


def _untile(tiles, tiles_y, tiles_x, tile_h, tile_w):
    return (tiles.reshape(tiles_y, tiles_x, tile_h, tile_w)
            .permute(0, 2, 1, 3).reshape(tiles_y * tile_h, tiles_x * tile_w))


def _tile_pixel_centers(num_tiles, tiles_x, tile_h, tile_w, y_offset, device):
    """(px, py) global pixel centers, each (tiles, tile_h*tile_w)."""
    lin = torch.arange(tile_h * tile_w, device=device)
    tidx = torch.arange(num_tiles, device=device)
    ox = ((tidx % tiles_x) * tile_w).float()
    oy = ((tidx // tiles_x) * tile_h).float() + y_offset
    px = (lin % tile_w).float()[None, :] + 0.5 + ox[:, None]
    py = (lin // tile_w).float()[None, :] + 0.5 + oy[:, None]
    return px, py


def edge_scores(px, py, e):
    """s_i = (px*e_i0 + py*e_i1) + e_i2 for i = 0..2, in the kernels' order."""
    return [(px * e[..., i, 0] + py * e[..., i, 1]) + e[..., i, 2] for i in range(3)]


def rasterize(setup: TriangleSetup, bins: Bins, width: int, height: int, tile_h: int,
              tile_w: int, chunk: int = 64, y_offset=0, longest: int | None = None):
    """-> (tri_id (H, W) int32 [-1 = background], z (H, W) f32 [1.0 bg]).

    Folds the bin lists in chunks with all tiles batched per step; a masked
    first-argmin within a chunk and a strict `<` across chunks make the
    earliest list entry among equal minimal depths win (depth func LESS,
    first drawn wins ties). Chunks past the fullest list hold only padding
    (-1) and cannot change the result, so the trip count may stop at the
    chunk that holds list position `longest`, a host bound on the lists'
    length (the kernels' plain versions pass theirs); without it the trip
    count is static, every chunk of the lists' capacity (as JAX's fold),
    with no host read."""
    tiles_y, tiles_x = height // tile_h, width // tile_w
    num_tiles = tiles_y * tiles_x
    cap = bins.ids.shape[1]
    dev = bins.ids.device
    px, py = _tile_pixel_centers(num_tiles, tiles_x, tile_h, tile_w, y_offset, dev)
    px, py = px[:, :, None], py[:, :, None]

    bound = cap if longest is None else min(longest, cap)
    n_chunks = -(-bound // chunk) if num_tiles else 0
    zbuf = torch.full((num_tiles, tile_h * tile_w), float("inf"), device=dev)
    idbuf = torch.full((num_tiles, tile_h * tile_w), -1, dtype=torch.int32, device=dev)
    for c in range(n_chunks):
        ids = bins.ids[:, c * chunk:(c + 1) * chunk]
        idsc = torch.clamp(ids, min=0).long()
        ok = (ids >= 0) & setup.valid[idsc]
        e = setup.edges[idsc][:, None]                 # (tiles, 1, chunk, 3, 3)
        wv = setup.w_clip[idsc][:, None]
        zv = setup.z[idsc][:, None]
        s0, s1, s2 = edge_scores(px, py, e)            # (tiles, p, chunk)
        inside = (s0 >= 0.0) & (s1 >= 0.0) & (s2 >= 0.0) & ok[:, None, :]
        den = (s0 * wv[..., 0] + s1 * wv[..., 1]) + s2 * wv[..., 2]
        zc = ((s0 * zv[..., 0] + s1 * zv[..., 1]) + s2 * zv[..., 2]) / torch.where(
            den == 0.0, 1.0, den)
        zc = torch.where(inside & (den > 0.0) & (zc >= 0.0) & (zc <= 1.0), zc, float("inf"))
        best = torch.argmin(zc, dim=-1)                # first minimum
        best_z = torch.gather(zc, -1, best[..., None])[..., 0]
        upd = best_z < zbuf
        zbuf = torch.where(upd, best_z, zbuf)
        idbuf = torch.where(upd, torch.gather(ids, 1, best), idbuf)
    z_img = _untile(zbuf, tiles_y, tiles_x, tile_h, tile_w)
    id_img = _untile(idbuf, tiles_y, tiles_x, tile_h, tile_w)
    return id_img, torch.where(torch.isinf(z_img), 1.0, z_img)


def pack_pixel_data(setup: TriangleSetup) -> torch.Tensor:
    """Per-triangle data needed at pixel rate as one (T, 16) row, so a pixel
    reads one contiguous 64-byte row: [edges(9), pad(1), z_clip(3), w_clip(3)]."""
    t = setup.edges.shape[0]
    return torch.cat(
        [
            setup.edges.reshape(t, 9),
            torch.zeros((t, 1), dtype=torch.float32, device=setup.edges.device),
            setup.z,
            setup.w_clip,
        ],
        dim=1,
    )


def _sum3(x):
    """x[..., 0] + x[..., 1] + x[..., 2], added left to right: the card and
    the CPU then round alike (a reduction kernel may associate otherwise,
    and an edge score is a sum that cancels)."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _bary_from_scores(scores, wv):
    """Homogeneous barycentrics from edge scores B_i and vertex clip w.

    Returns (lam_affine, lam_persp, one_over_w): perspective barycentrics are
    B / sum(B); screen-affine ones are (B*w) / sum(B*w)."""
    sum_b = _sum3(scores)
    lam_persp = scores / torch.where(sum_b == 0, 1.0, sum_b)[..., None]
    bw = scores * wv
    sum_bw = _sum3(bw)
    lam = bw / torch.where(sum_bw == 0, 1.0, sum_bw)[..., None]
    one_over_w = sum_b / torch.where(sum_bw == 0, 1.0, sum_bw)
    return lam, lam_persp, one_over_w


def barycentrics_from_packed(packed, tri_id, px, py):
    """Same results as `barycentrics_at`, one row read per pixel.
    packed: (T, 16) from pack_pixel_data. Returns (lam, lam_persp, one_over_w)."""
    row = packed[tri_id.long()]  # (..., 16)
    e = row[..., :9].reshape(row.shape[:-1] + (3, 3))
    ph = torch.stack([px, py, torch.ones_like(px)], -1)
    scores = _sum3(e * ph[..., None, :])
    return _bary_from_scores(scores, row[..., 13:16])


def barycentrics_at(setup: TriangleSetup, tri_id, px, py):
    """Perspective-correct barycentrics for given pixels.

    tri_id (...,) int (>= 0), px/py (...,) pixel centers ->
    (lam_affine (..., 3), lam_persp (..., 3), one_over_w (...,)).
    lam_affine interpolates screen-affine quantities; lam_persp interpolates
    vertex attributes (uv, normals) perspective-correctly.
    """
    tri_id = tri_id.long()
    e = setup.edges[tri_id]  # (..., 3, 3)
    ph = torch.stack([px, py, torch.ones_like(px)], -1)  # (..., 3)
    scores = _sum3(e * ph[..., None, :])  # (..., 3)
    return _bary_from_scores(scores, setup.w_clip[tri_id])
