"""Host-side math library (numpy) — the port's copy of the JAX package's
`utils/mathlib.py` (same names, same conventions, same arithmetic).

Conventions of the reference SIMD math library
(`Engine/Include/Utils/MathLib.h`, `Engine/Source/Utils/MathLib.cpp`):

* Matrices are row-major storage, **column-vector** convention: ``M @ v`` with
  the translation in the last column (MathLib.h:710-720).
* ``projection_matrix1`` maps view-space z to NDC z in [0, 1]
  (MathLib.cpp:35-68), left-handed, +z forward.
* ``from_euler_angle`` matches ``Matrix3x3::FromEulerAngle`` (MathLib.h:656-670).
* Cubemap face/direction mapping matches ``CalcCubeMapCoordinate`` /
  ``CalcCubeMapDirection`` (MathLib.cpp:73-159) which follow the D3D cubemap
  layout (+X,-X,+Y,-Y,+Z,-Z).
* Frustum planes via Gribb-Hartmann extraction (MathLib.h:1024-1041) with
  the loose AABB containment test used by the octree culling.

Device-side (torch) counterparts of the per-pixel helpers (octahedral
normal packing, view reconstruction) live in ``ops.common``.
"""

from __future__ import annotations

import math

import numpy as np

Deg2Rad = math.pi / 180.0
Rad2Deg = 180.0 / math.pi


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


def projection_matrix0(fov: float, ratio: float, near_z: float, far_z: float) -> np.ndarray:
    """Projection with ndc.z in [-1, 1] (MathLib.cpp:12-32)."""
    htan = math.tan(fov * 0.5)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (ratio * htan)
    m[1, 1] = 1.0 / htan
    m[2, 2] = (near_z + far_z) / (far_z - near_z)
    m[2, 3] = (2 * near_z * far_z) / (near_z - far_z)
    m[3, 2] = 1.0
    return m


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


class AABB:
    __slots__ = ("min", "max")

    def __init__(self, mn=None, mx=None):
        self.min = np.asarray(
            mn if mn is not None else [np.inf, np.inf, np.inf], dtype=np.float32
        )
        self.max = np.asarray(
            mx if mx is not None else [-np.inf, -np.inf, -np.inf], dtype=np.float32
        )

    def extend(self, p) -> None:
        self.min = np.minimum(self.min, p)
        self.max = np.maximum(self.max, p)

    def union(self, other: "AABB") -> "AABB":
        return AABB(np.minimum(self.min, other.min), np.maximum(self.max, other.max))

    def center(self) -> np.ndarray:
        return (self.min + self.max) * 0.5

    def extents(self) -> np.ndarray:
        return (self.max - self.min) * 0.5

    def contains(self, other: "AABB") -> bool:
        return bool(np.all(self.min <= other.min) and np.all(other.max <= self.max))

    def transformed(self, m: np.ndarray) -> "AABB":
        """Matches `operator*(Matrix4x4, AABB)` (MathLib.cpp:5-10): transforms
        only the two corner points (not all 8), a deliberate reference quirk."""
        a = transform_point(m, self.min)
        b = transform_point(m, self.max)
        return AABB(np.minimum(a, b), np.maximum(a, b))

    def __repr__(self):
        return f"AABB({self.min}, {self.max})"


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


def frustum_contains_aabb(planes: np.ndarray, mn: np.ndarray, mx: np.ndarray) -> bool:
    """Conservative AABB-vs-frustum: outside iff fully behind any plane."""
    n = planes[:, :3]
    d = planes[:, 3]
    # p-vertex: corner most along each plane normal
    p = np.where(n > 0, mx[None, :], mn[None, :])
    return bool(np.all(np.einsum("ij,ij->i", n, p) + d >= 0))


def frustum_cull_aabbs(planes: np.ndarray, mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
    """Vectorized frustum test over N boxes -> bool mask (N,): a box is
    culled when it lies fully behind any plane (the reference's LooseOctree
    traversal, LooseOctree.h:256-277, as one vectorized test)."""
    n = planes[:, :3]  # (6,3)
    d = planes[:, 3]  # (6,)
    p = np.where(n[None, :, :] > 0, maxs[:, None, :], mins[:, None, :])  # (N,6,3)
    dist = np.einsum("nij,ij->ni", p, n) + d[None, :]
    return np.all(dist >= 0, axis=1)


# Spherical / cubemap mapping (MathLib.cpp:73-159)

def from_spherical(theta: float, phi: float) -> np.ndarray:
    st = math.sin(theta)
    return np.array([st * math.cos(phi), st * math.sin(phi), math.cos(theta)], dtype=np.float32)


def cubemap_direction(face: int, u: float, v: float) -> np.ndarray:
    """Direction for face uv in [0,1]^2 after mapping to [-1,1] (env_map_gen.hlsl:18-44).

    The reference has two implementations of this mapping that disagree: the
    CPU one (MathLib.cpp:138-159) takes u,v already in [-1,1], the shader one
    maps uv from [0,1]. This mirrors the shader, which the image pipeline
    uses; `cubemap_direction_signed` is the CPU behavior.
    """
    u = 2 * u - 1
    v = 2 * v - 1
    return cubemap_direction_signed(face, u, v)


def cubemap_direction_signed(face: int, u: float, v: float) -> np.ndarray:
    table = {
        0: (1.0, -v, -u),
        1: (-1.0, -v, u),
        2: (u, 1.0, v),
        3: (u, -1.0, -v),
        4: (u, -v, 1.0),
        5: (-u, -v, -1.0),
    }
    d = np.array(table[int(face)], dtype=np.float32)
    return d / np.linalg.norm(d)


def cubemap_coordinate(direction) -> tuple[int, float, float]:
    """Inverse mapping: direction -> (face, u, v in [0,1]) (MathLib.cpp:73-136)."""
    d = np.asarray(direction, dtype=np.float64)
    d = d / np.linalg.norm(d)
    ax, ay, az = abs(d[0]), abs(d[1]), abs(d[2])
    if ax > ay and ax > az:
        if d[0] > 0:
            face, tc = 0, (-d[2] / ax, -d[1] / ax)
        else:
            face, tc = 1, (d[2] / ax, -d[1] / ax)
    elif ay > ax and ay > az:
        if d[1] > 0:
            face, tc = 2, (d[0] / ay, d[2] / ay)
        else:
            face, tc = 3, (d[0] / ay, -d[2] / ay)
    else:
        if d[2] > 0:
            face, tc = 4, (d[0] / az, -d[1] / az)
        else:
            face, tc = 5, (-d[0] / az, -d[1] / az)
    return face, (tc[0] + 1) * 0.5, (tc[1] + 1) * 0.5


# Octahedral normal packing (global.hlsli:100-138), numpy version

def _nz_sign(x: np.ndarray) -> np.ndarray:
    """HLSL-style sign: -1 for x<0 else +1 (global.hlsli:85-99)."""
    return np.where(x < 0, -1.0, 1.0).astype(np.float32)


def encode_octahedron(dirs: np.ndarray) -> np.ndarray:
    """(..., 3) unit vectors -> (..., 2) uv in [0, 1]."""
    d = np.asarray(dirs, dtype=np.float32)
    s = np.abs(d).sum(axis=-1, keepdims=True)
    d = d / s
    xy = d[..., :2]
    cond = d[..., 2:3] < 0
    folded = _nz_sign(xy) * np.stack(
        [1.0 - np.abs(d[..., 1]), 1.0 - np.abs(d[..., 0])], axis=-1
    )
    xy = np.where(cond, folded, xy)
    return xy * 0.5 + 0.5


def decode_octahedron(uv: np.ndarray) -> np.ndarray:
    """(..., 2) uv in [0, 1] -> (..., 3) unit vectors."""
    uv = np.asarray(uv, dtype=np.float32)
    xy = uv * 2.0 - 1.0
    z = 1.0 - np.abs(xy[..., 0]) - np.abs(xy[..., 1])
    cond = z < 0
    folded = _nz_sign(xy) * np.stack(
        [1.0 - np.abs(xy[..., 1]), 1.0 - np.abs(xy[..., 0])], axis=-1
    )
    xy = np.where(cond[..., None], folded, xy)
    d = np.concatenate([xy, z[..., None]], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)
