"""Host-side math library (numpy) — the port's copy of the parts of the JAX
package's `utils/mathlib.py` that the camera, the scene and the scene packer
use (same conventions, same arithmetic).

Conventions of the reference SIMD math library
(`Engine/Include/Utils/MathLib.h`, `Engine/Source/Utils/MathLib.cpp`):

* Matrices are row-major storage, **column-vector** convention: ``M @ v`` with
  the translation in the last column (MathLib.h:710-720).
* ``projection_matrix1`` maps view-space z to NDC z in [0, 1]
  (MathLib.cpp:35-68), left-handed, +z forward.
* ``from_euler_angle`` matches ``Matrix3x3::FromEulerAngle`` (MathLib.h:656-670).
* Frustum planes via Gribb-Hartmann extraction (MathLib.h:1024-1041) with
  the loose AABB containment test used by the octree culling.
"""

from __future__ import annotations

import math

import numpy as np

Deg2Rad = math.pi / 180.0


def identity4() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def from_euler_angle(a: float, b: float, c: float) -> np.ndarray:
    """3x3 rotation, argument order exactly as Matrix3x3::FromEulerAngle(a,b,c).

    (The reference names the parameters yaw/pitch/roll but call sites pass
    (roll, yaw, pitch); we reproduce the matrix, not the naming.)
    """
    ca, sa = math.cos(a), math.sin(a)
    cb, sb = math.cos(b), math.sin(b)
    cc, sc = math.cos(c), math.sin(c)
    return np.array(
        [
            [ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc],
            [sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc],
            [-sb, cb * sc, cb * cc],
        ],
        dtype=np.float32,
    )


def compose_trs(translation, rotation_deg, scale) -> np.ndarray:
    """World matrix as built by SceneObject::PostDeserialized (Scene.cpp:30-35).

    SetRotation(rx,ry,rz in radians) -> SetTranslation -> SetScale, i.e.
    M = T * R * S in column-vector convention.
    """
    t = np.asarray(translation, dtype=np.float32)
    s = np.asarray(scale, dtype=np.float32)
    r = from_euler_angle(
        float(rotation_deg[0]) * Deg2Rad,
        float(rotation_deg[1]) * Deg2Rad,
        float(rotation_deg[2]) * Deg2Rad,
    )
    m = identity4()
    m[:3, :3] = r * s[None, :]  # scale each basis column
    m[:3, 3] = t
    return m


def quick_inverse(m: np.ndarray) -> np.ndarray:
    """Inverse of a TRS matrix (Matrix4x4::QuickInverse, MathLib.h:786-811)."""
    rs = m[:3, :3]
    scale = np.linalg.norm(rs, axis=0)  # column lengths
    rot = rs / scale[None, :]
    inv_m = (rot.T) / scale[:, None]
    inv_t = inv_m @ m[:3, 3]
    out = identity4()
    out[:3, :3] = inv_m
    out[:3, 3] = -inv_t
    return out


def projection_matrix1(fov: float, ratio: float, near_z: float, far_z: float) -> np.ndarray:
    """Projection with ndc.z in [0, 1] (MathLib.cpp:35-68); the engine default."""
    htan = math.tan(fov * 0.5)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (ratio * htan)
    m[1, 1] = 1.0 / htan
    m[2, 2] = far_z / (far_z - near_z)
    m[2, 3] = (near_z * far_z) / (near_z - far_z)
    m[3, 2] = 1.0
    return m


def transform_point(m: np.ndarray, p) -> np.ndarray:
    v = m @ np.append(np.asarray(p, dtype=np.float32), 1.0)
    return v[:3]


def transform_vector(m: np.ndarray, p) -> np.ndarray:
    v = m @ np.append(np.asarray(p, dtype=np.float32), 0.0)
    return v[:3]


def frustum_planes_from_matrix(view_proj: np.ndarray) -> np.ndarray:
    """Gribb-Hartmann plane extraction (FrustumVolume::FromMatrix).

    Returns (6, 4) plane coefficients (a,b,c,d) with inward-facing normals:
    a point p is inside when dot(n, p) + d >= 0 for all planes. Plane order:
    left, right, bottom, top, near, far. NDC z in [0, 1] convention.
    """
    r0, r1, r2, r3 = view_proj[0], view_proj[1], view_proj[2], view_proj[3]
    planes = np.stack(
        [
            r3 + r0,  # left:   x >= -w
            r3 - r0,  # right:  x <= w
            r3 + r1,  # bottom
            r3 - r1,  # top
            r2,       # near:   z >= 0
            r3 - r2,  # far:    z <= w
        ]
    ).astype(np.float32)
    return planes


def frustum_cull_aabbs(planes: np.ndarray, mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
    """Vectorized frustum test over N boxes -> bool mask (N,): a box is
    culled when it lies fully behind any plane (the reference's LooseOctree
    traversal, LooseOctree.h:256-277, as one vectorized test)."""
    n = planes[:, :3]  # (6,3)
    d = planes[:, 3]  # (6,)
    p = np.where(n[None, :, :] > 0, maxs[:, None, :], mins[:, None, :])  # (N,6,3)
    dist = np.einsum("nij,ij->ni", p, n) + d[None, :]
    return np.all(dist >= 0, axis=1)
