"""Camera matrices of a pose (Camera.cpp, MathLib.cpp), numpy float32."""

from __future__ import annotations

import math

import numpy as np


def euler(a: float, b: float, c: float) -> np.ndarray:
    """Matrix3x3::FromEulerAngle(a, b, c), called as (roll, yaw, pitch)."""
    ca, sa = math.cos(a), math.sin(a)
    cb, sb = math.cos(b), math.sin(b)
    cc, sc = math.cos(c), math.sin(c)
    return np.array([[ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc],
                     [sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc],
                     [-sb, cb * sc, cb * cc]], dtype=np.float32)


def pose_matrices(position, yaw: float, pitch: float, fov: float, width: int, height: int,
                  near: float, far: float) -> dict:
    """{view, inv_view, view_proj, planes (6, 4), position} of a fly camera
    moved to `position` and rotated by (0, yaw, pitch)."""
    world = np.eye(4, dtype=np.float32)
    world[:3, 3] += np.asarray(position, np.float32)
    rot = euler(0.0, yaw, pitch)
    scale = np.linalg.norm(world[:3, :3], axis=0)
    world[:3, :3] = rot * scale[None, :]
    rs = world[:3, :3]
    sc = np.linalg.norm(rs, axis=0)
    inv_r = (rs / sc[None, :]).T / sc[:, None]
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = inv_r
    view[:3, 3] = -(inv_r @ world[:3, 3])
    htan = math.tan(fov * 0.5)
    proj = np.zeros((4, 4), dtype=np.float32)
    proj[0, 0] = 1.0 / (width / height * htan)
    proj[1, 1] = 1.0 / htan
    proj[2, 2] = far / (far - near)
    proj[2, 3] = (near * far) / (near - far)
    proj[3, 2] = 1.0
    vp = proj @ view
    r0, r1, r2, r3 = vp
    planes = np.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r2, r3 - r2]).astype(np.float32)
    return {"view": view, "inv_view": world.copy(), "view_proj": vp.astype(np.float32),
            "planes": planes, "position": world[:3, 3].copy()}
