"""Vertex stage, clipless triangle setup and a depth-min scatter raster.

The setup is the homogeneous (Olano-Greer) setup the renderer specifies
(gbuffer.hlsl's vertex stage, D3D's fixed-function setup), formula for
formula; coverage is the three edge scores >= 0 at the pixel centre, depth
LESS with the first-drawn triangle winning ties.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PAIRS_PER_CHUNK = 1 << 24   # (pixel, triangle) candidates tested at once


class Setup(NamedTuple):
    z: torch.Tensor        # (T, 3) clip z
    w: torch.Tensor        # (T, 3) clip w
    edges: torch.Tensor    # (T, 3, 3) edge rows in pixel coordinates
    aabb: torch.Tensor     # (T, 4) xmin, ymin, xmax, ymax (whole pixels)
    valid: torch.Tensor    # (T,) bool


def vertex_transform(positions, model, view_proj):
    """(V, 3) object positions -> (V, 4) clip, clip = P V M p."""
    ph = torch.cat([positions, torch.ones_like(positions[..., :1])], dim=-1)
    world = (model[None] * ph[:, None, :]).sum(-1)
    return (view_proj[None, :, :] * world[:, None, :]).sum(-1)


def transform_directions(dirs, normal_mat):
    return (normal_mat[None] * dirs[:, None, :]).sum(-1)


def setup_triangles(clip, tris, width: int, height: int, w_eps: float = 1e-4) -> Setup:
    v = clip[tris.long()]
    w = v[..., 3]
    z = v[..., 2]
    front = w > w_eps
    inv_w = 1.0 / torch.where(front, w, 1.0)
    x = (v[..., 0] * inv_w * 0.5 + 0.5) * width
    y = (1.0 - (v[..., 1] * inv_w * 0.5 + 0.5)) * height
    ax = torch.where(front[:, 0], x[:, 0], torch.where(front[:, 1], x[:, 1], x[:, 2]))
    ay = torch.where(front[:, 0], y[:, 0], torch.where(front[:, 1], y[:, 1], y[:, 2]))
    hx, hy = 0.5 * width, 0.5 * height
    vx = v[..., 0] * hx + (hx - ax[:, None]) * w
    vy = -(v[..., 1] * hy) + (hy - ay[:, None]) * w

    def cross(j, k):
        return torch.stack([vy[:, j] * w[:, k] - vy[:, k] * w[:, j],
                            w[:, j] * vx[:, k] - w[:, k] * vx[:, j],
                            vx[:, j] * vy[:, k] - vx[:, k] * vy[:, j]], -1)

    b0, b1, b2 = cross(1, 2), cross(2, 0), cross(0, 1)
    det = b0[:, 0] * vx[:, 0] + b0[:, 1] * vy[:, 0] + b0[:, 2] * w[:, 0]
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    edges = torch.stack([b0, b1, b2], 1) * inv_det[:, None, None]
    c = edges[:, :, 2] + -(edges[:, :, 0] * ax[:, None] + edges[:, :, 1] * ay[:, None])
    edges = torch.cat([edges[:, :, :2], c[:, :, None]], dim=2)

    big = 3e38
    xmin = torch.where(front, x, big).amin(-1)
    xmax = torch.where(front, x, -big).amax(-1)
    ymin = torch.where(front, y, big).amin(-1)
    ymax = torch.where(front, y, -big).amax(-1)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        crossing = front[:, a] != front[:, b]
        t = (w_eps - w[:, a]) / torch.where(w[:, b] == w[:, a], 1.0, w[:, b] - w[:, a])
        cx = ((v[:, a, 0] + t * (v[:, b, 0] - v[:, a, 0])) / w_eps * 0.5 + 0.5) * width
        cy = (1.0 - ((v[:, a, 1] + t * (v[:, b, 1] - v[:, a, 1])) / w_eps * 0.5 + 0.5)) * height
        xmin = torch.where(crossing, torch.minimum(xmin, cx), xmin)
        xmax = torch.where(crossing, torch.maximum(xmax, cx), xmax)
        ymin = torch.where(crossing, torch.minimum(ymin, cy), ymin)
        ymax = torch.where(crossing, torch.maximum(ymax, cy), ymax)
    aabb = torch.stack([torch.clamp(torch.floor(xmin), 0, width),
                        torch.clamp(torch.floor(ymin), 0, height),
                        torch.clamp(torch.ceil(xmax), 0, width),
                        torch.clamp(torch.ceil(ymax), 0, height)], -1)
    any_crossing = (front != front[:, :1]).any(-1)
    far_ok = (z <= w).any(-1) | any_crossing
    valid = (front.any(-1) & (det > 0) & (aabb[:, 2] > aabb[:, 0]) & (aabb[:, 3] > aabb[:, 1])
             & far_ok)
    return Setup(z, w, edges, aabb, valid)


def edge_scores(px, py, e):
    return [(px * e[..., i, 0] + py * e[..., i, 1]) + e[..., i, 2] for i in range(3)]


def rasterize(s: Setup, width: int, height: int):
    """-> (tri_id (H, W) int32, -1 for background; ndc depth (H, W), 1.0
    for background). Every valid triangle is tested at every pixel centre
    of its screen AABB; the key (depth bits, id) takes the least depth and,
    among equal depths, the least id."""
    dev = s.edges.device
    ids = torch.nonzero(s.valid).flatten()
    box = s.aabb[ids].long()
    bw = box[:, 2] - box[:, 0]
    area = bw * (box[:, 3] - box[:, 1])
    ends = torch.cumsum(area, 0)
    best = torch.full((height * width,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=dev)
    lo = 0
    while lo < len(ids):
        base = int(ends[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(ends, base + PAIRS_PER_CHUNK, right=True))
        hi = max(hi, lo + 1)
        t, b, n, w_ = ids[lo:hi], box[lo:hi], area[lo:hi], bw[lo:hi]
        rep = torch.repeat_interleave(torch.arange(len(t), device=dev), n)
        off = torch.arange(len(rep), device=dev) - torch.repeat_interleave(
            torch.cumsum(n, 0) - n, n)
        xi = b[rep, 0] + off % w_[rep]
        yi = b[rep, 1] + off // w_[rep]
        tri = t[rep]
        e = s.edges[tri]
        s0, s1, s2 = edge_scores(xi.float() + 0.5, yi.float() + 0.5, e)
        wv, zv = s.w[tri], s.z[tri]
        den = (s0 * wv[:, 0] + s1 * wv[:, 1]) + s2 * wv[:, 2]
        zc = ((s0 * zv[:, 0] + s1 * zv[:, 1]) + s2 * zv[:, 2]) / torch.where(den == 0.0, 1.0,
                                                                              den)
        keep = ((s0 >= 0.0) & (s1 >= 0.0) & (s2 >= 0.0) & (den > 0.0) & (zc >= 0.0)
                & (zc <= 1.0))
        zc = zc + 0.0   # -0.0 -> +0.0: the key orders depth by its bits
        key = (zc.view(torch.int32).long() << 32) | tri.long()
        best.scatter_reduce_(0, (yi * width + xi)[keep], key[keep], "amin")
        lo = hi
    covered = best != torch.iinfo(torch.int64).max
    tri_id = torch.where(covered, best & 0xFFFFFFFF, -1).to(torch.int32).reshape(height, width)
    depth = torch.where(covered, (best >> 32).to(torch.int32).view(torch.float32),
                        1.0).reshape(height, width)
    return tri_id, depth
