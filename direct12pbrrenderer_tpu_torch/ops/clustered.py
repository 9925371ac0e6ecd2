"""Clustered light culling — counterpart of `ops/clustered.py`.

View-space cluster AABBs in closed form (`clustered_compute.hlsl`) and the
compaction of the visible lights into the (max_active, 14) rows the shading
loop walks, in light index order (`clustered_culling.hlsl`'s sequential i
loop). Cluster grid 24 x 16 x 8, <= 32 lights per cluster.

`cull_lights_to_clusters`, `build_cluster_light_params` and
`cluster_index_image` are the literal transcription of
`clustered_culling.hlsl` / `clustered.hlsli:45-59`: a sphere-vs-AABB test
over the whole (clusters, lights) grid, each cluster's list compacted by an
exclusive prefix sum in light index order (the InterlockedAdd loop), and
the per-pixel cluster index. No frame runs them: the frame's light loops
test each pixel's cluster in place (kernels D and G).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import (
    CLUSTER_X,
    CLUSTER_Y,
    CLUSTER_Z,
    CULLING_RADIUS_COEFFICIENT,
    MAX_LIGHTS_PER_CLUSTER,
)

NUM_CLUSTERS = CLUSTER_X * CLUSTER_Y * CLUSTER_Z


def cluster_bounds(fov: float, ratio: float, near: float, far: float) -> np.ndarray:
    """(NUM_CLUSTERS, 2, 3) view-space AABBs (clustered_compute.hlsl:21-42),
    host numpy, once per camera config."""
    tan_half = np.tan(fov / 2)

    def zplane_intersection(ndc_x, ndc_y, view_z):
        ray = np.stack(
            [
                ndc_x * ratio * tan_half * near,
                ndc_y * tan_half * near,
                np.broadcast_to(near, ndc_x.shape),
            ],
            -1,
        )
        return ray * (view_z / ray[..., 2])[..., None]

    gx, gy, gz = np.meshgrid(np.arange(CLUSTER_X), np.arange(CLUSTER_Y),
                             np.arange(CLUSTER_Z), indexing="ij")
    znear = near * (far / near) ** (gz / CLUSTER_Z)
    zfar = near * (far / near) ** ((gz + 1) / CLUSTER_Z)
    min_ndc_x = 2 * gx / CLUSTER_X - 1
    min_ndc_y = 2 * gy / CLUSTER_Y - 1
    max_ndc_x = 2 * (gx + 1) / CLUSTER_X - 1
    max_ndc_y = 2 * (gy + 1) / CLUSTER_Y - 1
    p = [
        zplane_intersection(min_ndc_x, min_ndc_y, znear),
        zplane_intersection(min_ndc_x, min_ndc_y, zfar),
        zplane_intersection(max_ndc_x, max_ndc_y, znear),
        zplane_intersection(max_ndc_x, max_ndc_y, zfar),
    ]
    mn = np.minimum(np.minimum(p[0], p[1]), np.minimum(p[2], p[3]))
    mx = np.maximum(np.maximum(p[0], p[1]), np.maximum(p[2], p[3]))
    # cluster index = z + x*Z + y*X*Z (clustered.hlsli:39-43)
    bounds = np.zeros((NUM_CLUSTERS, 2, 3), np.float32)
    idx = gz + gx * CLUSTER_Z + gy * CLUSTER_X * CLUSTER_Z
    bounds[idx.ravel(), 0] = mn.reshape(-1, 3)
    bounds[idx.ravel(), 1] = mx.reshape(-1, 3)
    return bounds


def cull_lights_to_clusters(
    bounds,          # (C, 2, 3) view-space cluster AABBs
    view,            # (4, 4)
    light_pos,       # (L, 3) world
    light_radius,    # (L,) attenuation radius
    light_intensity, # (L,)
    light_valid,     # (L,) bool
):
    """-> (cluster_lists (C, 32) int32 [-1 pad], counts (C,) int32).

    clustered_culling.hlsl:19-39: culling radius = 1.814 * r * sqrt(I),
    sphere-vs-AABB in view space, per-cluster list capped at 32 in light
    index order. The view transform is an elementwise product and sum, as
    in `build_active_lights` (no matmul, so no reduced-precision product).
    """
    ph = torch.cat([light_pos, torch.ones_like(light_pos[:, :1])], -1)
    pos_view = (ph[:, None, :] * view[None, :, :]).sum(-1)[:, :3]
    cull_r = light_radius * CULLING_RADIUS_COEFFICIENT * torch.sqrt(light_intensity)

    mn = bounds[:, 0][:, None, :]  # (C, 1, 3)
    mx = bounds[:, 1][:, None, :]
    closest = torch.minimum(torch.maximum(pos_view[None, :, :], mn), mx)  # (C, L, 3)
    d = pos_view[None, :, :] - closest
    hit = (d * d).sum(-1) < (cull_r * cull_r)[None, :]
    hit = hit & light_valid[None, :]

    pos = torch.cumsum(hit, dim=1) - hit.long()  # exclusive prefix
    counts = torch.clamp(hit.sum(dim=1), max=MAX_LIGHTS_PER_CLUSTER).to(torch.int32)
    write = hit & (pos < MAX_LIGHTS_PER_CLUSTER)
    slot = torch.where(write, pos, MAX_LIGHTS_PER_CLUSTER)
    c, l = bounds.shape[0], light_pos.shape[0]
    light_ids = torch.arange(l, dtype=torch.int32, device=light_pos.device)[None, :].expand(c, l)
    # the unwritten hits and misses all land in slot 32, which is dropped
    lists = torch.full((c, MAX_LIGHTS_PER_CLUSTER + 1), -1, dtype=torch.int32,
                       device=light_pos.device)
    lists.scatter_(1, slot, torch.where(write, light_ids, -1))
    return lists[:, :MAX_LIGHTS_PER_CLUSTER], counts


def build_cluster_light_params(
    cluster_lists,   # (C, 32) int32 from cull_lights_to_clusters
    light_pos, light_color, light_intensity, light_attenuation,
):
    """(C, 32, 12) per-cluster light parameter rows:
    [pos(3), color(3), intensity, kc, kl, kq, valid, pad], gathered once per
    cluster slot (the reference's Cluster.LightIndex -> PointLights[]
    indirection)."""
    lvalid = cluster_lists >= 0
    lidx = torch.clamp(cluster_lists, min=0).long()
    return torch.cat(
        [
            light_pos[lidx],
            light_color[lidx],
            light_intensity[lidx][..., None],
            light_attenuation[lidx][..., 1:4],
            lvalid[..., None].to(torch.float32),
            torch.zeros(lidx.shape + (1,), dtype=torch.float32, device=lidx.device),
        ],
        dim=-1,
    )


def build_active_lights(light_pos, light_color, light_intensity, light_attenuation,
                        light_valid, view, max_active: int):
    """Compact the visible lights into (max_active, 14) rows:
    [pos_w(3), color(3), intensity, kc, kl, kq, pos_view(3), cull_r], in
    light index order; padding rows are all zero (cull_r = 0)."""
    l = light_pos.shape[0]
    ph = torch.cat([light_pos, torch.ones_like(light_pos[:, :1])], -1)
    pos_view = (ph[:, None, :] * view[None, :, :]).sum(-1)[:, :3]
    cull_r = (light_attenuation[:, 0] * CULLING_RADIUS_COEFFICIENT
              * torch.sqrt(torch.clamp(light_intensity, min=0.0)))
    rows = torch.cat(
        [
            light_pos, light_color, light_intensity[:, None],
            light_attenuation[:, 1:4], pos_view,
            torch.where(light_valid, cull_r, 0.0)[:, None],
        ],
        dim=1,
    )
    score = torch.where(light_valid,
                        l - torch.arange(l, dtype=torch.int32, device=light_pos.device), 0)
    if l < max_active:
        score = torch.nn.functional.pad(score, (0, max_active - l))
    top = torch.topk(score.to(torch.int32), max_active).values
    ids = torch.where(top > 0, l - top, 0)
    out = rows[torch.clamp(ids, max=l - 1).long()]
    return torch.where((top > 0)[:, None], out, 0.0)


def cluster_index_image(uv_x, uv_y, z_view, near: float, far: float):
    """Per-pixel cluster index (clustered.hlsli:45-59). uv origin top-left.
    x and y are floored, the z slice truncated toward zero, as in the JAX
    package."""
    sx = torch.clamp(torch.floor(uv_x * CLUSTER_X), 0, CLUSTER_X - 1).to(torch.int32)
    sy = torch.clamp(torch.floor((1.0 - uv_y) * CLUSTER_Y), 0, CLUSTER_Y - 1).to(torch.int32)
    zc = torch.clamp(z_view, near, far)
    sz = torch.clamp(
        (CLUSTER_Z * torch.log(zc / near) / math.log(far / near)).to(torch.int32),
        0,
        CLUSTER_Z - 1,
    )
    return sz + sx * CLUSTER_Z + sy * CLUSTER_X * CLUSTER_Z
