"""Order-2 spherical-harmonics baker — the port's copy of the JAX package's
`utils/sh.py` (the pack and the baker a cubemap's SH come from).

Re-implements `Engine/Source/Utils/SH.cpp` with the same basis definitions,
cosine-lobe convolution and shader packing (SH.cpp:6-85, 201-222), but
replaces the 100k-sample Monte-Carlo projection (SH.cpp:87-153) with exact
deterministic quadrature over the cubemap texels (per-texel solid angle
weights) — same integral, no sampling noise, and fully vectorized.

The shader consumes the pack as 7 float4s (global.hlsli:27-36) and evaluates
irradiance as in deferred_shading.hlsl:23-54 (ops/shading.py);
`eval_irradiance` mirrors that shader path on the host (the console's
GenerateIrradianceMap; the CPU debug path SH.cpp:224-238 drops the
xy/yz/zx terms, a known reference quirk)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

PI = np.pi

# Basis scale constants (SH.cpp:6-66)
BASIS_COEF = np.array(
    [0.282095, 0.488603, 0.488603, 0.488603, 1.092548, 1.092548, 0.315392, 1.092548, 0.546274],
    dtype=np.float64,
)


def sh_basis(dirs: np.ndarray) -> np.ndarray:
    """(..., 3) directions -> (..., 9) SH2 basis values (SH.cpp:6-37)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    one = np.ones_like(x)
    return np.stack(
        [
            0.282095 * one,
            0.488603 * y,
            0.488603 * z,
            0.488603 * x,
            1.092548 * x * y,
            1.092548 * y * z,
            0.315392 * (3 * z * z - 1),
            1.092548 * x * z,
            0.546274 * (x * x - y * y),
        ],
        axis=-1,
    )


def cosine_sh_coefficient(l: int) -> float:
    """SH coefficient of max(cos theta, 0) at Y(l,0) (SH.cpp:69-85)."""
    if l == 0:
        return float(np.sqrt(PI) / 2.0)
    if l == 1:
        return float(np.sqrt(PI / 3.0))
    if l == 2:
        return float(np.sqrt(5.0 * PI) / 8.0)
    return 0.0


@dataclass
class SH2CoefficientsPack:
    """7 float4s, exactly the shader ABI (SH.h:20-29, global.hlsli:27-36)."""

    sha_r: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    shb_r: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    sha_g: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    shb_g: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    sha_b: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    shb_b: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    shc: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))

    def as_array(self) -> np.ndarray:
        return np.stack(
            [self.sha_r, self.shb_r, self.sha_g, self.shb_g, self.sha_b, self.shb_b, self.shc]
        ).astype(np.float32)

    @classmethod
    def from_array(cls, a: np.ndarray) -> "SH2CoefficientsPack":
        a = np.asarray(a, np.float32).reshape(7, 4)
        return cls(*[a[i].copy() for i in range(7)])


def cubemap_texel_directions_and_weights(size: int) -> tuple[np.ndarray, np.ndarray]:
    """Directions (6, S, S, 3) and solid angles (S, S) of cubemap texel centers.

    Face/uv conventions match env_map_gen.hlsl:18-44 (u,v in [0,1] mapped to
    [-1,1]); the solid angle of a texel at (u,v) is 4/( (u^2+v^2+1)^1.5 ) * dA.
    """
    t = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(t, t, indexing="xy")  # u varies along x(axis=1)? see below
    # u: columns (axis 1), v: rows (axis 0)
    u = t[None, :].repeat(size, 0)
    v = t[:, None].repeat(size, 1)
    one = np.ones_like(u)
    faces = [
        np.stack([one, -v, -u], -1),   # +X
        np.stack([-one, -v, u], -1),   # -X
        np.stack([u, one, v], -1),     # +Y
        np.stack([u, -one, -v], -1),   # -Y
        np.stack([u, -v, one], -1),    # +Z
        np.stack([-u, -v, -one], -1),  # -Z
    ]
    dirs = np.stack(faces)  # (6, S, S, 3)
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs_n = dirs / norm
    # solid angle of a texel at (u,v) on the z=1 face: dw = dA / (u^2+v^2+1)^(3/2)
    # with dA in [-1,1]^2 units (texel side 2/size)
    da = (2.0 / size) ** 2
    weights = da / (u * u + v * v + 1.0) ** 1.5  # same for all faces
    return dirs_n, weights


def project_environment_map(face_pixels: np.ndarray) -> np.ndarray:
    """Project a cubemap (6, S, S, >=3) onto SH2 -> irradiance-convolved
    radiance coefficients (3, 9), matching SHBaker::ProjectEnvironmentMap's
    output convention (projection, then *InvPI*K*A per band, SH.cpp:128-151).
    """
    size = face_pixels.shape[1]
    dirs, w = cubemap_texel_directions_and_weights(size)
    basis = sh_basis(dirs)  # (6, S, S, 9)
    rgb = np.asarray(face_pixels[..., :3], dtype=np.float64)
    # integral over sphere: sum color * basis * dOmega
    coeffs = np.einsum("fijc,fijn,ij->cn", rgb, basis, w)  # (3, 9)

    # irradiance convolution per band
    for l in range(3):
        k = np.sqrt(4 * PI / (2 * l + 1))
        a = cosine_sh_coefficient(l)
        for m in range(-l, l + 1):
            n = l * l + m + l
            coeffs[:, n] *= (1.0 / PI) * k * a
    return coeffs.astype(np.float32)


def pack_sh_coefficients(coeffs: np.ndarray) -> SH2CoefficientsPack:
    """(3, 9) channel coefficients -> shader pack (SH.cpp:201-222)."""
    c = np.asarray(coeffs, dtype=np.float64) * BASIS_COEF[None, :]
    r, g, b = c[0], c[1], c[2]
    return SH2CoefficientsPack(
        sha_r=np.array([r[3], r[1], r[2], r[0]], np.float32),
        shb_r=np.array([r[4], r[5], r[6] * 3, r[7]], np.float32),
        sha_g=np.array([g[3], g[1], g[2], g[0]], np.float32),
        shb_g=np.array([g[4], g[5], g[6] * 3, g[7]], np.float32),
        sha_b=np.array([b[3], b[1], b[2], b[0]], np.float32),
        shb_b=np.array([b[4], b[5], b[6] * 3, b[7]], np.float32),
        shc=np.array([r[8], g[8], b[8], 0.0], np.float32),
    )


def generate_sh_coefficients(cubemap) -> SH2CoefficientsPack:
    """CubeMapTextureData::GenerateSHCoefficients equivalent."""
    return pack_sh_coefficients(project_environment_map(cubemap.face_arrays(0)))


def eval_irradiance(pack: SH2CoefficientsPack, normals: np.ndarray) -> np.ndarray:
    """Evaluate packed SH irradiance for (..., 3) normals — the *shader* path
    (deferred_shading.hlsl:23-47), including all five band-2 terms."""
    n = np.asarray(normals, dtype=np.float32)
    a = np.concatenate([n, np.ones_like(n[..., :1])], axis=-1)  # (x,y,z,1)
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    b = np.stack([x * y, y * z, z * z, z * x], axis=-1)  # normal.xyzz * normal.yzzx
    c = x * x - y * y
    l0l1 = np.stack(
        [a @ pack.sha_r, a @ pack.sha_g, a @ pack.sha_b], axis=-1
    )
    l2 = np.stack([b @ pack.shb_r, b @ pack.shb_g, b @ pack.shb_b], axis=-1)
    l2 = l2 + np.stack([pack.shc[0] * c, pack.shc[1] * c, pack.shc[2] * c], axis=-1)
    return l0l1 + l2


def generate_irradiance_map(cubemap, map_size: int) -> np.ndarray:
    """SHBaker::GenerateIrradianceMap equivalent -> (6, S, S, 3) float32.

    Uses the shader evaluation path (CalcIrradiance2-complete), see module
    docstring for the reference quirk."""
    pack = generate_sh_coefficients(cubemap)
    dirs, _ = cubemap_texel_directions_and_weights(map_size)
    return eval_irradiance(pack, dirs.astype(np.float32))
