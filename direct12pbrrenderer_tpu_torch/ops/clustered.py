"""Clustered light culling — counterpart of `ops/clustered.py`.

View-space cluster AABBs in closed form (`clustered_compute.hlsl`) and the
compaction of the visible lights into the (max_active, 14) rows the shading
loop walks, in light index order (`clustered_culling.hlsl`'s sequential i
loop). Cluster grid 24 x 16 x 8, <= 32 lights per cluster.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (
    CLUSTER_X,
    CLUSTER_Y,
    CLUSTER_Z,
    CULLING_RADIUS_COEFFICIENT,
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
