"""Procedural meshes: unit box and UV sphere (DefaultResource.cpp) — the
port's copy of the JAX package's `resource/default_meshes.py`.

The sphere is the dx12-book stacks/slices construction (poles + rings) used
for both the skybox geometry and CreateStandardSphereModel; the reference's
swapped AABB min/max (DefaultResource.cpp:208-209) is corrected here (the
bound is actually used for culling in our pipeline; the reference never
frustum-culled the sphere model through that path).
"""

from __future__ import annotations

import numpy as np

from .storage import EVertexFormat, MeshData, STANDARD_VERTEX_DTYPE


def box_mesh(width: float = 1.0, height: float = 1.0, depth: float = 1.0) -> MeshData:
    hw, hh, hd = width / 2, height / 2, depth / 2
    # 24 verts, 4 per face: (pos, normal, tangent, uv)
    faces = [
        # front (-z)
        ([(-hw, -hh, -hd), (-hw, hh, -hd), (hw, hh, -hd), (hw, -hh, -hd)],
         (0, 0, -1), (1, 0, 0), [(0, 1), (0, 0), (1, 0), (1, 1)]),
        # back (+z)
        ([(-hw, -hh, hd), (hw, -hh, hd), (hw, hh, hd), (-hw, hh, hd)],
         (0, 0, 1), (-1, 0, 0), [(1, 1), (0, 1), (0, 0), (1, 0)]),
        # top (+y)
        ([(-hw, hh, -hd), (-hw, hh, hd), (hw, hh, hd), (hw, hh, -hd)],
         (0, 1, 0), (1, 0, 0), [(0, 1), (0, 0), (1, 0), (1, 1)]),
        # bottom (-y)
        ([(-hw, -hh, -hd), (hw, -hh, -hd), (hw, -hh, hd), (-hw, -hh, hd)],
         (0, -1, 0), (-1, 0, 0), [(1, 1), (0, 1), (0, 0), (1, 0)]),
        # left (-x)
        ([(-hw, -hh, hd), (-hw, hh, hd), (-hw, hh, -hd), (-hw, -hh, -hd)],
         (-1, 0, 0), (0, 0, -1), [(0, 1), (0, 0), (1, 0), (1, 1)]),
        # right (+x)
        ([(hw, -hh, -hd), (hw, hh, -hd), (hw, hh, hd), (hw, -hh, hd)],
         (1, 0, 0), (0, 0, 1), [(0, 1), (0, 0), (1, 0), (1, 1)]),
    ]
    verts = np.zeros(24, dtype=STANDARD_VERTEX_DTYPE)
    indices = []
    for f, (pos, n, t, uv) in enumerate(faces):
        for i in range(4):
            verts[f * 4 + i] = (pos[i], n, t, (1, 1, 1), uv[i])
        base = f * 4
        indices += [base, base + 1, base + 2, base, base + 2, base + 3]
    return MeshData.from_arrays(
        EVertexFormat.P3F_N3F_T3F_C3F_T2F, verts,
        np.asarray(indices, np.uint32), None,
        (-hw, -hh, -hd), (hw, hh, hd),
    )


def sphere_mesh(
    radius: float = 1.0, longitude_slices: int = 32, latitude_slices: int = 24
) -> MeshData:
    verts = []
    pi = np.pi
    verts.append(((0, radius, 0), (0, 1, 0), (1, 0, 0), (0, 0, 0), (0, 0)))
    phi_step = pi / latitude_slices
    theta_step = 2 * pi / longitude_slices
    for i in range(1, latitude_slices):
        phi = i * phi_step
        for j in range(longitude_slices + 1):
            theta = j * theta_step
            p = (
                radius * np.sin(phi) * np.cos(theta),
                radius * np.cos(phi),
                radius * np.sin(phi) * np.sin(theta),
            )
            t = np.array([-np.sin(phi) * np.sin(theta), 0.0, np.sin(phi) * np.cos(theta)])
            tl = np.linalg.norm(t)
            t = t / tl if tl > 0 else np.array([1.0, 0, 0])
            n = np.asarray(p) / radius
            verts.append((p, tuple(n), tuple(t), (0, 0, 0), (theta / (2 * pi), phi / pi)))
    verts.append(((0, -radius, 0), (0, -1, 0), (1, 0, 0), (0, 0, 0), (0, 1)))

    va = np.zeros(len(verts), dtype=STANDARD_VERTEX_DTYPE)
    for i, (p, n, t, c, uv) in enumerate(verts):
        va[i] = (p, n, t, c, uv)

    idx = []
    ring = longitude_slices + 1
    for i in range(1, longitude_slices + 1):
        idx += [0, i + 1, i]
    base = 1
    for i in range(latitude_slices - 2):
        for j in range(longitude_slices):
            a = base + i * ring + j
            b = base + (i + 1) * ring + j
            idx += [a, a + 1, b, b, a + 1, b + 1]
    south = len(verts) - 1
    base = south - ring
    for i in range(longitude_slices):
        idx += [south, base + i, base + i + 1]

    r = radius
    return MeshData.from_arrays(
        EVertexFormat.P3F_N3F_T3F_C3F_T2F, va, np.asarray(idx, np.uint32), None,
        (-r, -r, -r), (r, r, r),
    )
