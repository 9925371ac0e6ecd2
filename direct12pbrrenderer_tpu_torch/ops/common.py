"""Shared shading helpers on tensors — counterpart of `ops/common.py`.

The torch mirror of `Shader/global.hlsli` + `Shader/brdf.hlsli`: gamma/sRGB
transfer functions, octahedral normal packing, luminance, Cook-Torrance GGX
terms, Hammersley sequence and GGX importance sampling, and cubemap
addressing/sampling. Same formulas and the same operation order as the JAX
package, so float32 results agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

PI = 3.14159265359
INV_PI = 0.31830988618
EPSILON = 1e-6


# ---------------------------------------------------------------------------
# Transfer functions
# ---------------------------------------------------------------------------

def decode_gamma(c):
    """pow 2.2 decode (global.hlsli:75-78)."""
    return torch.pow(torch.clamp(c, min=0.0), 2.2)


def encode_gamma(c):
    return torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)


def srgb_eotf(c):
    """Exact piecewise sRGB->linear, as D3D samplers apply to *_SRGB SRVs."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def luminance(rgb):
    """Rec.709 luma (global.hlsli:140-143)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


# ---------------------------------------------------------------------------
# Octahedral normals (global.hlsli:100-138)
# ---------------------------------------------------------------------------

def _nz_sign(x):
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def encode_octahedron(d):
    s = d.abs().sum(-1, keepdim=True)
    d = d / s
    xy = d[..., :2]
    folded = _nz_sign(xy) * torch.stack(
        [1.0 - d[..., 1].abs(), 1.0 - d[..., 0].abs()], dim=-1
    )
    xy = torch.where(d[..., 2:3] < 0, folded, xy)
    return xy * 0.5 + 0.5


def decode_octahedron(uv):
    xy = uv * 2.0 - 1.0
    z = 1.0 - xy[..., 0].abs() - xy[..., 1].abs()
    folded = _nz_sign(xy) * torch.stack(
        [1.0 - xy[..., 1].abs(), 1.0 - xy[..., 0].abs()], dim=-1
    )
    xy = torch.where((z < 0)[..., None], folded, xy)
    d = torch.cat([xy, z[..., None]], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def normalize(v, floor):
    """v / max(|v|, floor) along the last axis."""
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=floor)


# ---------------------------------------------------------------------------
# BRDF terms (brdf.hlsli)
# ---------------------------------------------------------------------------

def distribution_ggx(n_dot_h, roughness):
    a = roughness * roughness
    t = (n_dot_h * n_dot_h) * (a * a - 1.0) + 1.0
    return a * a / torch.clamp(PI * t * t, min=EPSILON)


def fresnel_schlick(n_dot_l, f0):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - n_dot_l, min=EPSILON), 5.0)


def geometry_schlick_ggx(n_dot_v, k):
    return n_dot_v / torch.clamp(n_dot_v * (1.0 - k) + k, min=EPSILON)


def geometry_smith(n_dot_l, n_dot_v, k):
    return geometry_schlick_ggx(n_dot_v, k) * geometry_schlick_ggx(n_dot_l, k)


def compute_f0(albedo, metallic):
    return 0.04 * (1.0 - metallic) + albedo * metallic


def brdf(albedo, metallic, roughness, normal, view_dir, light_dir):
    """Cook-Torrance GGX (brdf.hlsli:47-67). All inputs broadcastable, unit
    vectors in the last axis; returns (..., 3)."""
    half = normalize(light_dir + view_dir, EPSILON)
    n_dot_l = torch.clamp((normal * light_dir).sum(-1), min=0.0)
    n_dot_v = torch.clamp((normal * view_dir).sum(-1), min=0.0)
    n_dot_h = torch.clamp((normal * half).sum(-1), min=0.0)

    f0 = compute_f0(albedo, metallic[..., None])
    f = fresnel_schlick(n_dot_l[..., None], f0)
    d = distribution_ggx(n_dot_h, roughness)
    k = (roughness + 1.0) ** 2 / 8.0
    g = geometry_smith(n_dot_l, n_dot_v, k)
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    spec = f * (d * g / torch.clamp(4.0 * n_dot_l * n_dot_v, min=1e-4))[..., None]
    return kd * albedo * INV_PI + spec


# ---------------------------------------------------------------------------
# Culling and sampling sequences (brdf.hlsli:70-113)
# ---------------------------------------------------------------------------

def frustum_cull_aabbs(planes, mins, maxs):
    """(N,) bool mask from (6, 4) inward-facing planes and (N, 3) world AABB
    corners — same p-vertex selection and op order as the JAX twin and the
    host version in utils.mathlib."""
    n = planes[:, :3]
    d = planes[:, 3]
    p = torch.where(n[None, :, :] > 0, maxs[:, None, :], mins[:, None, :])
    dist = (p * n[None, :, :]).sum(-1) + d[None, :]
    return torch.all(dist >= 0, dim=1)


def hammersley(n: int) -> np.ndarray:
    """(n, 2) Hammersley points (host numpy, static)."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = (((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)) & 0xFFFFFFFF
    bits = (((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)) & 0xFFFFFFFF
    bits = (((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)) & 0xFFFFFFFF
    bits = (((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)) & 0xFFFFFFFF
    return np.stack([i / n, bits * 2.3283064365386963e-10], axis=-1).astype(np.float32)


def ggx_importance_sample(roughness, normal, xi):
    """Microfacet half-vector for uniform xi (brdf.hlsli:70-97).

    normal: (..., 3); xi: broadcastable (..., 2); roughness scalar/broadcast.
    """
    a = roughness * roughness
    phi = 2.0 * PI * xi[..., 0]
    q = (1.0 - xi[..., 1]) / (1.0 + (a * a - 1.0) * xi[..., 1])
    # sin_theta = sqrt(1 - cos^2) turns one ulp of cos_theta near 1 into
    # ~1e-4 of sin_theta at low roughness, so cos_theta must be the correctly
    # rounded fp32 sqrt. Some CPU builds of torch.sqrt are off by an ulp; a
    # float64 sqrt rounded to fp32 is exact on every backend.
    cos_theta = torch.sqrt(q.double()).to(q.dtype)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    h = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], -1
    )
    z_up = normal.new_tensor([0.0, 0.0, 1.0]).expand(normal.shape)
    x_up = normal.new_tensor([1.0, 0.0, 0.0]).expand(normal.shape)
    up = torch.where(normal[..., 2:3].abs() < 0.999, z_up, x_up)
    tangent = normalize(torch.linalg.cross(normal, up, dim=-1), EPSILON)
    bitangent = torch.linalg.cross(normal, tangent, dim=-1)
    world = tangent * h[..., 0:1] + bitangent * h[..., 1:2] + normal * h[..., 2:3]
    return normalize(world, EPSILON)


# ---------------------------------------------------------------------------
# Cubemap addressing (env_map_gen.hlsl:18-44 / MathLib.cpp:73-136)
# ---------------------------------------------------------------------------

def cubemap_face_dirs(size: int) -> np.ndarray:
    """(6, size, size, 3) unit directions of texel centers (numpy, host)."""
    t = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    u = t[None, :].repeat(size, 0)
    v = t[:, None].repeat(size, 1)
    one = np.ones_like(u)
    faces = np.stack(
        [
            np.stack([one, -v, -u], -1),
            np.stack([-one, -v, u], -1),
            np.stack([u, one, v], -1),
            np.stack([u, -one, -v], -1),
            np.stack([u, -v, one], -1),
            np.stack([-u, -v, -one], -1),
        ]
    )
    return (faces / np.linalg.norm(faces, axis=-1, keepdims=True)).astype(np.float32)


def cubemap_coords(dirs):
    """(..., 3) directions -> (face_idx int32, u, v in [0,1]) — branchless
    vectorized CalcCubeMapCoordinate."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()

    # D3D tie-break: x wins strict, then y strict, else z.
    is_x = (ax > ay) & (ax > az)
    is_y = (~is_x) & (ay > ax) & (ay > az)

    inv = 1.0 / torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=EPSILON)
    face = torch.where(
        is_x,
        torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)),
    ).to(torch.int32)

    u = torch.where(
        is_x,
        torch.where(x > 0, -z, z) * inv,
        torch.where(is_y, x * inv, torch.where(z > 0, x, -x) * inv),
    )
    v = torch.where(
        is_x,
        -y * inv,
        torch.where(is_y, torch.where(y > 0, z, -z) * inv, -y * inv),
    )
    return face, (u + 1.0) * 0.5, (v + 1.0) * 0.5


def bilerp(c00, c01, c10, c11, fx, fy):
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def sample_cubemap_bilinear(faces, dirs):
    """Bilinear cubemap fetch. faces: (6, s, s, c); dirs: (..., 3) -> (..., c).
    Per-face clamped filtering (no cross-face seam blending)."""
    size = faces.shape[1]
    face, u, v = cubemap_coords(dirs)
    x = u * size - 0.5
    y = v * size - 0.5
    x0 = torch.clamp(torch.floor(x), 0, size - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, size - 1).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=size - 1)
    y1 = torch.clamp(y0 + 1, max=size - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]

    flat = faces.reshape(6 * size * size, faces.shape[-1])
    base = face.to(torch.int64) * (size * size)

    def fetch(yy, xx):
        return flat[base + yy * size + xx]

    return bilerp(fetch(y0, x0), fetch(y0, x1), fetch(y1, x0), fetch(y1, x1), fx, fy)


class CubeMipAtlas:
    """Cubemap mip chain flattened into one (N, 4, C) quad-record tensor +
    offsets: each record holds a texel's clamp-addressed 2x2 bilinear
    neighborhood, so a trilinear sample costs two computed-index gathers."""

    def __init__(self, offsets, sizes_arr, flat):
        self.offsets = offsets        # (n_mips,) int32
        self.sizes_arr = sizes_arr    # (n_mips,) int32
        self.flat = flat              # (N, 4, C) float32
        self.sizes = tuple(int(s) for s in sizes_arr.tolist())
        self.offsets_host = tuple(int(o) for o in offsets.tolist())   # `offsets` on the host
        self.n_mips = len(self.sizes)

    @classmethod
    def from_mips(cls, mip_faces, device) -> "CubeMipAtlas":
        """Build from a list of (6, s_m, s_m, C) mips (arrays or tensors)."""
        offs, quads, cur = [], [], 0
        for m in mip_faces:
            a = m.detach().cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)
            offs.append(cur)
            cur += 6 * a.shape[1] * a.shape[2]
            right = a[:, :, np.minimum(np.arange(a.shape[2]) + 1, a.shape[2] - 1)]
            down = a[:, np.minimum(np.arange(a.shape[1]) + 1, a.shape[1] - 1)]
            diag = right[:, np.minimum(np.arange(a.shape[1]) + 1, a.shape[1] - 1)]
            quads.append(np.stack([a, right, down, diag], axis=3).reshape(-1, 4, a.shape[-1]))
        sizes = [int(m.shape[1]) for m in mip_faces]
        return cls(
            torch.as_tensor(np.asarray(offs, np.int32), device=device),
            torch.as_tensor(np.asarray(sizes, np.int32), device=device),
            torch.as_tensor(np.concatenate(quads, axis=0).astype(np.float32), device=device),
        )


def _cube_atlas_bilinear(atlas: CubeMipAtlas, dirs, mip):
    """Bilinear fetch at integer mip (int or int tensor): one quad gather.
    An int mip takes its size and offset from the host tuples (no device
    gather and no upload); a tensor mip gathers them on the device."""
    face, u, v = cubemap_coords(dirs)
    if isinstance(mip, int):
        size, off = atlas.sizes[mip], atlas.offsets_host[mip]
        sizef, hi = float(size), float(size - 1)
    else:
        mip = torch.as_tensor(mip, dtype=torch.int64, device=dirs.device)
        size = atlas.sizes_arr[mip].to(torch.int64)
        off = atlas.offsets[mip].to(torch.int64)
        sizef, hi = size.to(dirs.dtype), (size - 1).to(dirs.dtype)
    x = u * sizef - 0.5
    y = v * sizef - 0.5
    x0 = torch.clamp(torch.clamp(torch.floor(x), min=0.0), max=hi).to(torch.int64)
    y0 = torch.clamp(torch.clamp(torch.floor(y), min=0.0), max=hi).to(torch.int64)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]

    quad = atlas.flat[off + face.to(torch.int64) * size * size + y0 * size + x0]
    return bilerp(quad[..., 0, :], quad[..., 1, :], quad[..., 2, :], quad[..., 3, :],
                   fx, fy)


def sample_cube_atlas_trilinear(atlas: CubeMipAtlas, dirs, mip_level):
    lvl = torch.clamp(mip_level, 0.0, atlas.n_mips - 1.0)
    lo = torch.floor(lvl).to(torch.int64)
    frac = (lvl - lo)[..., None]
    c0 = _cube_atlas_bilinear(atlas, dirs, lo)
    c1 = _cube_atlas_bilinear(atlas, dirs, torch.clamp(lo + 1, max=atlas.n_mips - 1))
    return c0 * (1 - frac) + c1 * frac


def sample_cubemap_trilinear(mip_faces: list, dirs, mip_level):
    """Trilinear: bilinear on floor/ceil mips, lerped. `mip_faces` is a list
    of (6, s_m, s_m, c) tensors; mip_level broadcastable over dirs[:-1]."""
    n_mips = len(mip_faces)
    lvl = torch.clamp(mip_level, 0.0, n_mips - 1.0)
    lo = torch.floor(lvl).to(torch.int64)
    hi = torch.clamp(lo + 1, max=n_mips - 1)
    frac = (lvl - lo)[..., None]

    # unroll over the (few) mips, select per sample
    out_lo = dirs.new_zeros(dirs.shape[:-1] + (mip_faces[0].shape[-1],))
    out_hi = out_lo
    for m in range(n_mips):
        s = sample_cubemap_bilinear(mip_faces[m], dirs)
        out_lo = torch.where((lo == m)[..., None], s, out_lo)
        out_hi = torch.where((hi == m)[..., None], s, out_hi)
    return out_lo * (1 - frac) + out_hi * frac


def make_quad_tex2d(tex):
    """(h, w, c) -> (h*w, 4, c) clamp-addressed quad records."""
    h, w = tex.shape[0], tex.shape[1]
    dev = tex.device
    right = tex[:, torch.clamp(torch.arange(w, device=dev) + 1, max=w - 1)]
    down = tex[torch.clamp(torch.arange(h, device=dev) + 1, max=h - 1)]
    diag = right[torch.clamp(torch.arange(h, device=dev) + 1, max=h - 1)]
    return torch.stack([tex, right, down, diag], dim=2).reshape(h * w, 4, tex.shape[-1])


def sample_quad_tex2d(quad, h: int, w: int, u, v):
    """Bilinear clamp sample from make_quad_tex2d records."""
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.clamp(torch.floor(x), 0, w - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, h - 1).to(torch.int64)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    q = quad[y0 * w + x0]
    return bilerp(q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :], fx, fy)


def sample_texture2d_bilinear(tex, u, v, wrap: bool = True):
    """(h, w, c) bilinear sample at uv on `tex`'s device; wrap or clamp
    addressing. Texel indices stay integer: wrap takes `torch.remainder`,
    whose result has the divisor's sign as `jnp.mod`'s does."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    if wrap:
        x0 = torch.remainder(x0, w)
        y0 = torch.remainder(y0, h)
        x1 = torch.remainder(x0 + 1, w)
        y1 = torch.remainder(y0 + 1, h)
    else:
        x0 = torch.clamp(x0, 0, w - 1)
        y0 = torch.clamp(y0, 0, h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = tex.reshape(h * w, tex.shape[-1])
    c00 = flat[(y0 * w + x0).long()]
    c01 = flat[(y0 * w + x1).long()]
    c10 = flat[(y1 * w + x0).long()]
    c11 = flat[(y1 * w + x1).long()]
    return bilerp(c00, c01, c10, c11, fx, fy)
