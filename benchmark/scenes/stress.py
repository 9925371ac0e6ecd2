"""The Sponza-class stress scene as plain arrays: a frozen copy of the
port's `tools/stress_scene.py` (terrain, checker albedo, ring or grid
lights) and of `chip_smoke.py`'s `procedural_sky`, with the albedo map
switched on. The same formulas and draws, so the port's generators and
these give equal arrays; only the grid lights' jitter takes its seed from
the caller (the port fixes it at 11).

`build(spec, seed)` returns a dict of numpy arrays that both the program's
scene adapter (`benchmark/program.py`) and the plain reference read.
"""

from __future__ import annotations

import numpy as np

def terrain(cells_x: int, cells_y: int, size: float = 40.0, height: float = 1.5,
            seed: int = 3) -> dict:
    """(cells_x * cells_y * 2) triangles of rolling terrain: positions,
    normals, tangents, colors, uvs (V, k) float32, tris (T, 3) uint32 and
    the mesh's bounds (Python floats), as `terrain_mesh` builds them."""
    rng = np.random.default_rng(seed)
    nx, ny = cells_x + 1, cells_y + 1
    xs = np.linspace(-size / 2, size / 2, nx, dtype=np.float32)
    zs = np.linspace(-size / 2, size / 2, ny, dtype=np.float32)
    x, z = np.meshgrid(xs, zs, indexing="xy")
    y = np.zeros_like(x)
    for _ in range(4):
        fx, fz = rng.uniform(0.2, 1.2, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        y += rng.uniform(0.2, 0.5) * np.sin(x * fx + ph[0]) * np.cos(z * fz + ph[1])
    y *= height / 2
    dx = np.gradient(y, axis=1) / (xs[1] - xs[0])
    dz = np.gradient(y, axis=0) / (zs[1] - zs[0])
    n = np.stack([-dx, np.ones_like(y), -dz], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u, v = np.meshgrid(np.linspace(0, 8, nx, dtype=np.float32),
                       np.linspace(0, 8, ny, dtype=np.float32), indexing="xy")
    c = np.arange(cells_x, dtype=np.uint32)
    r = np.arange(cells_y, dtype=np.uint32)[:, None]
    i00 = (r * nx + c).ravel()
    i10 = i00 + nx
    tris = np.stack([i00, i10, i10 + 1, i00, i10 + 1, i00 + 1], -1).reshape(-1, 3)
    v_count = nx * ny
    return {
        "positions": np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32),
        "normals": n.reshape(-1, 3).astype(np.float32),
        "tangents": np.broadcast_to(np.array([1, 0, 0], np.float32), (v_count, 3)).copy(),
        "colors": np.ones((v_count, 3), np.float32),
        "uvs": np.stack([u, v], -1).reshape(-1, 2).astype(np.float32),
        "tris": tris.astype(np.uint32),
        "bound_min": (float(xs[0]), float(y.min()), float(zs[0])),
        "bound_max": (float(xs[-1]), float(y.max()), float(zs[-1])),
    }


def checker(size: int = 256, seed: int = 5) -> np.ndarray:
    """(size, size, 4) uint8 sRGB albedo: a 16-texel checker with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    ch = (((xx // 16) ^ (yy // 16)) & 1).astype(np.float32)
    base = np.stack([0.45 + 0.25 * ch, 0.40 + 0.10 * ch, 0.30 + 0.05 * ch], -1)
    noise = rng.random((size, size, 1), np.float32) * 0.1
    rgba = np.concatenate([np.clip(base + noise, 0, 1), np.ones_like(noise)], -1)
    return (rgba * 255).astype(np.uint8)


def lights(n: int, seed: int) -> dict:
    """`n` point lights: a ring of 8-64, or above 64 small lights jittered
    on a grid from `seed` (the 1024-light operating point). Arrays of
    translation, color (float32), intensity and radius (float64)."""
    pos, col, inten, rad = [], [], [], []
    if n > 64:
        rng = np.random.default_rng(seed)
        side = int(np.ceil(np.sqrt(n)))
        for i in range(n):
            gx, gy = i % side, i // side
            px = (gx + rng.uniform(0.2, 0.8)) / side * 36.0 - 18.0
            pz = (gy + rng.uniform(0.2, 0.8)) / side * 36.0 - 18.0
            pos.append(np.array([px, rng.uniform(0.5, 2.0), pz], np.float32))
            col.append(rng.uniform(0.3, 1.0, 3).astype(np.float32))
            inten.append(3.0)
            rad.append(0.6)
    else:
        for i in range(n):
            a = 2 * np.pi * i / n
            pos.append(np.array([10 * np.cos(a), 2.5, 10 * np.sin(a)], np.float32))
            col.append(np.array([0.5 + 0.5 * np.cos(a), 0.6, 0.5 + 0.5 * np.sin(a)], np.float32))
            inten.append(25.0)
            rad.append(3.0)
    return {"translation": np.asarray(pos, np.float32).reshape(-1, 3),
            "color": np.asarray(col, np.float32).reshape(-1, 3),
            "intensity": np.asarray(inten, np.float64), "radius": np.asarray(rad, np.float64)}


def cube_face_dirs(size: int) -> np.ndarray:
    """(6, size, size, 3) unit directions of cube texel centres
    (env_map_gen.hlsl:18-44's face order and axes)."""
    t = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    u = t[None, :].repeat(size, 0)
    v = t[:, None].repeat(size, 1)
    one = np.ones_like(u)
    faces = np.stack([np.stack([one, -v, -u], -1), np.stack([-one, -v, u], -1),
                      np.stack([u, one, v], -1), np.stack([u, -one, -v], -1),
                      np.stack([u, -v, one], -1), np.stack([-u, -v, -one], -1)])
    return (faces / np.linalg.norm(faces, axis=-1, keepdims=True)).astype(np.float32)


def sky(size: int, sun_dir, sun_intensity: float) -> np.ndarray:
    """(6, size, size, 3) float32 HDR sky: horizon gradient, ground, sun disc."""
    dirs = cube_face_dirs(size)
    y = dirs[..., 1:2]
    horizon = np.array([0.35, 0.45, 0.65], np.float32)
    zenith = np.array([0.08, 0.18, 0.45], np.float32)
    ground = np.array([0.25, 0.22, 0.18], np.float32)
    t = np.clip(y, 0, 1) ** 0.6
    s = horizon * (1 - t) + zenith * t
    s = np.where(y < 0, ground * (1 + y), s).astype(np.float32)
    sun = np.array(sun_dir, np.float32)
    sun /= np.linalg.norm(sun)
    cos = (dirs * sun).sum(-1, keepdims=True)
    return (s + np.exp((cos - 1.0) * 800.0) * sun_intensity).astype(np.float32)


def build(spec: dict, seed: int) -> dict:
    """The scene of a configuration's `scene` block: mesh arrays, one
    material (albedo map on), lights and sky."""
    mesh = terrain(spec["cells_x"], spec["cells_y"], seed=spec["terrain_seed"])
    lgt = lights(spec["n_lights"], seed)
    return {
        "mesh": mesh,
        "material": {"albedo": np.ones(3, np.float32), "roughness": 0.7, "metallic": 0.05,
                     "emission": 0.0, "albedo_map": bool(spec["albedo_map"])},
        "albedo_map": checker(spec["texture_size"], spec["texture_seed"]),
        "lights": lgt,
        "sky": sky(spec["sky_size"], spec["sun_dir"], spec["sun_intensity"]),
    }
