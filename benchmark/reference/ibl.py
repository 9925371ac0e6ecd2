"""Image-based-lighting precompute from the sky's faces: the split-sum BRDF
LUT (precompute_brdf.hlsl), the GGX-prefiltered mip chain (env_map_gen.hlsl)
and the SH2 irradiance pack (SH.cpp, by exact quadrature over the texels).
Sums over the 1024 importance samples are taken in chunks, not one by one:
the order of float32 additions is not the renderer's, which moves the
products by rounding only."""

from __future__ import annotations

import numpy as np
import torch

from .texture import CubeMips

PI = 3.14159265359
EPS = 1e-6
SAMPLES = 1024
ENV_MIPS = 5
CHUNK = 128


def hammersley(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint32)
    b = ((i << 16) | (i >> 16)) & 0xFFFFFFFF
    b = (((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)) & 0xFFFFFFFF
    b = (((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)) & 0xFFFFFFFF
    b = (((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)) & 0xFFFFFFFF
    b = (((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)) & 0xFFFFFFFF
    return np.stack([i / n, b * 2.3283064365386963e-10], axis=-1).astype(np.float32)


def normalize(v, floor):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=floor)


def ggx_sample(roughness, normal, xi):
    """GGX half-vector around `normal` for uniform `xi` (brdf.hlsli:70-97)."""
    a = roughness * roughness
    phi = 2.0 * PI * xi[..., 0]
    q = (1.0 - xi[..., 1]) / (1.0 + (a * a - 1.0) * xi[..., 1])
    cos_t = torch.sqrt(q.double()).to(q.dtype)   # correctly rounded on every backend
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    h = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)
    h, normal = torch.broadcast_tensors(h, normal)
    z_up = normal.new_tensor([0.0, 0.0, 1.0]).expand(normal.shape)
    x_up = normal.new_tensor([1.0, 0.0, 0.0]).expand(normal.shape)
    up = torch.where(normal[..., 2:3].abs() < 0.999, z_up, x_up)
    tangent = normalize(torch.linalg.cross(normal, up, dim=-1), EPS)
    bitangent = torch.linalg.cross(normal, tangent, dim=-1)
    return normalize(tangent * h[..., 0:1] + bitangent * h[..., 1:2] + normal * h[..., 2:3], EPS)


def g_schlick(n_dot_v, k):
    return n_dot_v / torch.clamp(n_dot_v * (1.0 - k) + k, min=EPS)


def brdf_lut(size: int, device) -> torch.Tensor:
    """(size, size, 2): [NdotV row, roughness column] -> (scale, bias)."""
    xi = torch.as_tensor(hammersley(SAMPLES), device=device)
    ar = torch.arange(size, dtype=torch.float32, device=device)
    rough = (ar / (size - 1))[None, :, None].expand(size, size, 1)
    n_dot_v = ((ar + 1.0) / size)[:, None, None].expand(size, size, 1)
    v = torch.stack([torch.sqrt(1.0 - n_dot_v * n_dot_v), torch.zeros_like(n_dot_v), n_dot_v],
                    -1)
    normal = v.new_tensor([0.0, 0.0, 1.0]).expand(v.shape)
    k = rough * rough / 2.0
    acc = torch.zeros((size, size, 2), dtype=torch.float32, device=device)
    for c in range(0, SAMPLES, CHUNK):
        h = ggx_sample(rough, normal, xi[c:c + CHUNK])
        vh = (v * h).sum(-1)
        v_dot_h = torch.clamp(vh, min=0.0)
        l = normalize(2.0 * vh[..., None] * h - v, 1e-20)
        n_dot_l = torch.clamp(l[..., 2], min=0.0)
        n_dot_h = torch.clamp(h[..., 2], min=0.0)
        fc = torch.pow(1.0 - v_dot_h, 5.0)
        g = g_schlick(n_dot_v, k) * g_schlick(n_dot_l, k)
        g_vis = g * v_dot_h / torch.clamp(n_dot_h * n_dot_v, min=1e-4)
        ok = n_dot_l > 0.0
        acc += torch.stack([torch.where(ok, (1.0 - fc) * g_vis, 0.0).sum(-1),
                            torch.where(ok, fc * g_vis, 0.0).sum(-1)], -1)
    return acc / SAMPLES


def box_mips(faces: torch.Tensor) -> list[torch.Tensor]:
    """Per-face 2x2 mean chain of a (6, s, s, c) cube down to 1x1."""
    chain = [faces]
    while chain[-1].shape[1] > 1:
        f = chain[-1]
        s = f.shape[1] // 2
        chain.append(f.reshape(6, s, 2, s, 2, f.shape[-1]).mean(dim=(2, 4)))
    return chain


def ggx_d(n_dot_h, roughness):
    a = roughness * roughness
    t = (n_dot_h * n_dot_h) * (a * a - 1.0) + 1.0
    return a * a / torch.clamp(PI * t * t, min=EPS)


def face_dirs(size: int) -> np.ndarray:
    """(6, size, size, 3) unit directions of cube texel centres."""
    t = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    u = t[None, :].repeat(size, 0)
    v = t[:, None].repeat(size, 1)
    one = np.ones_like(u)
    d = np.stack([np.stack([one, -v, -u], -1), np.stack([-one, -v, u], -1),
                  np.stack([u, one, v], -1), np.stack([u, -one, -v], -1),
                  np.stack([u, -v, one], -1), np.stack([-u, -v, -one], -1)])
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def prefilter(src: CubeMips, out_size: int) -> list[torch.Tensor]:
    """GGX-prefiltered mips (roughness m / 4 at mip m); mip 0 is one
    bilinear fetch at the texel centre. The source lookup is trilinear at the
    sample's solid-angle mip."""
    dev = src.flat.device
    xi = torch.as_tensor(hammersley(SAMPLES), device=dev)
    texel_sa = 4.0 * PI / (6 * out_size * out_size)
    out = []
    for mip in range(ENV_MIPS):
        size = out_size >> mip
        rough = mip / (ENV_MIPS - 1)
        n = torch.as_tensor(face_dirs(size).astype(np.float32), device=dev)
        if mip == 0:
            out.append(src.bilinear(n, torch.zeros(n.shape[:-1], dtype=torch.long, device=dev)))
            continue
        v = n[..., None, :]
        color = torch.zeros((6, size, size, 3), dtype=torch.float32, device=dev)
        weight = torch.zeros((6, size, size), dtype=torch.float32, device=dev)
        for c in range(0, SAMPLES, CHUNK):
            h = ggx_sample(rough, v, xi[c:c + CHUNK])
            vh = (v * h).sum(-1, keepdim=True)
            l = normalize(2.0 * vh * h - v, 1e-20)
            n_dot_l = torch.clamp((v * l).sum(-1), min=0.0)
            n_dot_h = torch.clamp((v * h).sum(-1), min=0.0)
            pdf = ggx_d(n_dot_h, rough) * n_dot_h / (4.0 * torch.clamp(vh[..., 0], min=0.0)
                                                     + 1e-4)
            level = 0.5 * torch.log2(1.0 / (SAMPLES * pdf + 1e-4) / texel_sa)
            color += (src.trilinear(l, level) * n_dot_l[..., None]).sum(-2)
            weight += n_dot_l.sum(-1)
        out.append(color / torch.clamp(weight[..., None], min=1e-8))
    return out


def sh_pack(faces: np.ndarray) -> np.ndarray:
    """(7, 4) shader pack of the irradiance-convolved SH2 projection of a
    (6, S, S, 3) cube (SH.cpp:128-151, 201-222)."""
    size = faces.shape[1]
    t = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    u = t[None, :].repeat(size, 0)
    v = t[:, None].repeat(size, 1)
    d = face_dirs(size)
    wgt = (2.0 / size) ** 2 / (u * u + v * v + 1.0) ** 1.5
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    basis = np.stack([0.282095 * np.ones_like(x), 0.488603 * y, 0.488603 * z, 0.488603 * x,
                      1.092548 * x * y, 1.092548 * y * z, 0.315392 * (3 * z * z - 1),
                      1.092548 * x * z, 0.546274 * (x * x - y * y)], -1)
    c = np.einsum("fijc,fijn,ij->cn", faces[..., :3].astype(np.float64), basis, wgt)
    lobe = [np.sqrt(np.pi) / 2.0, np.sqrt(np.pi / 3.0), np.sqrt(5.0 * np.pi) / 8.0]
    for l in range(3):
        c[:, l * l:(l + 1) * (l + 1)] *= (1.0 / np.pi) * np.sqrt(4 * np.pi / (2 * l + 1)) * lobe[l]
    c = c * np.array([0.282095, 0.488603, 0.488603, 0.488603, 1.092548, 1.092548, 0.315392,
                      1.092548, 0.546274])[None, :]
    r, g, b = c
    return np.array([[r[3], r[1], r[2], r[0]], [r[4], r[5], r[6] * 3, r[7]],
                     [g[3], g[1], g[2], g[0]], [g[4], g[5], g[6] * 3, g[7]],
                     [b[3], b[1], b[2], b[0]], [b[4], b[5], b[6] * 3, b[7]],
                     [r[8], g[8], b[8], 0.0]], np.float32)
