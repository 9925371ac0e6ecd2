"""Image-based-lighting precompute — counterpart of `ops/ibl.py`.

Split-sum BRDF LUT + GGX-prefiltered environment mip chain
(`Shader/precompute_brdf.hlsl`, `Shader/env_map_gen.hlsl`): every output
texel in parallel, the importance samples streamed through a Python loop
(the JAX package's `lax.scan`) in the same order and the same chunking, so
the float32 sums accumulate in the same order. Runs once per skybox.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (
    BRDF_LUT_SIZE,
    IBL_SAMPLE_COUNT,
    PREFILTER_ENVMAP_MIP_LEVELS,
)

from . import common
from .common import PI, cubemap_face_dirs, geometry_smith, ggx_importance_sample, hammersley


def brdf_lut(size: int = BRDF_LUT_SIZE, samples: int = IBL_SAMPLE_COUNT, *,
             device) -> torch.Tensor:
    """(size, size, 2) split-sum LUT on `device`; [y, x] = (NdotV row,
    roughness column) (precompute_brdf.hlsl:23-61)."""
    xi = torch.as_tensor(hammersley(samples), device=device)
    ar = torch.arange(size, dtype=torch.float32, device=device)
    roughness = (ar / (size - 1))[None, :].expand(size, size)
    n_dot_v = ((ar + 1.0) / size)[:, None].expand(size, size)
    v = torch.stack(
        [torch.sqrt(1.0 - n_dot_v * n_dot_v), torch.zeros_like(n_dot_v), n_dot_v], -1
    )
    normal = v.new_tensor([0.0, 0.0, 1.0]).expand(v.shape)
    k = roughness * roughness / 2.0

    a_acc = torch.zeros((size, size), dtype=torch.float32, device=device)
    b_acc = torch.zeros_like(a_acc)
    for i in range(samples):
        h = ggx_importance_sample(roughness, normal, xi[i])
        v_dot_h = torch.clamp((v * h).sum(-1), min=0.0)
        l = 2.0 * (v * h).sum(-1, keepdim=True) * h - v
        l = l / torch.clamp(torch.linalg.vector_norm(l, dim=-1, keepdim=True), min=1e-20)
        n_dot_l = torch.clamp(l[..., 2], min=0.0)
        n_dot_h = torch.clamp(h[..., 2], min=0.0)

        fc = torch.pow(1.0 - v_dot_h, 5.0)
        g = geometry_smith(n_dot_l, n_dot_v, k)
        g_vis = g * v_dot_h / torch.clamp(n_dot_h * n_dot_v, min=1e-4)
        valid = n_dot_l > 0.0
        a_acc = a_acc + torch.where(valid, (1.0 - fc) * g_vis, 0.0)
        b_acc = b_acc + torch.where(valid, fc * g_vis, 0.0)
    return torch.stack([a_acc, b_acc], -1) / samples


def build_cubemap_mips(faces: torch.Tensor, mips: int) -> list[torch.Tensor]:
    """Box-filtered mip chain of a (6, s, s, c) cubemap (per-face 2x2 mean)."""
    chain = [faces]
    for _ in range(mips - 1):
        f = chain[-1]
        s = f.shape[1] // 2
        chain.append(f.reshape(6, s, 2, s, 2, f.shape[-1]).mean(dim=(2, 4)))
    return chain


def prefilter_env_map(
    skybox_mips: list[torch.Tensor],
    out_size: int = 512,
    out_mips: int = PREFILTER_ENVMAP_MIP_LEVELS,
    samples: int = IBL_SAMPLE_COUNT,
    sample_chunk: int = 32,
) -> list[torch.Tensor]:
    """GGX prefilter (env_map_gen.hlsl:50-104).

    skybox_mips: (6, s_m, s_m, 3) source mips for the PDF-driven trilinear
    source lookup. Returns `out_mips` tensors (6, out_size>>m, out_size>>m, 3).
    Mip 0 (roughness 0) is the exact identity: one bilinear fetch at the
    texel center."""
    device = skybox_mips[0].device
    xi_chunks = torch.as_tensor(hammersley(samples), device=device).reshape(
        samples // sample_chunk, sample_chunk, 2
    )
    texel_sa = 4.0 * PI / (6 * out_size * out_size)
    out = []
    for mip in range(out_mips):
        size = out_size >> mip
        roughness = mip / (out_mips - 1)
        n = torch.as_tensor(cubemap_face_dirs(size), device=device)  # (6, s, s, 3)
        if mip == 0:
            out.append(common.sample_cubemap_bilinear(skybox_mips[0], n))
            continue
        v = n[..., None, :]
        color_acc = torch.zeros((6, size, size, 3), dtype=torch.float32, device=device)
        weight_acc = torch.zeros((6, size, size), dtype=torch.float32, device=device)
        for xi_chunk in xi_chunks:
            h = ggx_importance_sample(roughness, v, xi_chunk[None, None, None, :, :])
            v_dot_h = (v * h).sum(-1, keepdim=True)
            l = 2.0 * v_dot_h * h - v
            l = l / torch.clamp(torch.linalg.vector_norm(l, dim=-1, keepdim=True), min=1e-20)
            n_dot_l = torch.clamp((v * l).sum(-1), min=0.0)
            n_dot_h = torch.clamp((v * h).sum(-1), min=0.0)
            h_dot_v = torch.clamp(v_dot_h[..., 0], min=0.0)

            d = common.distribution_ggx(n_dot_h, roughness)
            pdf = d * n_dot_h / (4.0 * h_dot_v + 1e-4)
            sample_sa = 1.0 / (samples * pdf + 1e-4)
            mip_level = 0.5 * torch.log2(sample_sa / texel_sa)

            color = common.sample_cubemap_trilinear(skybox_mips, l, mip_level)
            color_acc = color_acc + (color * n_dot_l[..., None]).sum(-2)
            weight_acc = weight_acc + n_dot_l.sum(-1)
        out.append(color_acc / torch.clamp(weight_acc[..., None], min=1e-8))
    return out


def prefilter_env_map_from_texture(cubemap, out_size: int = 512, *, device,
                                   **kw) -> list[np.ndarray]:
    """CubeMapTextureData -> prefiltered mips (numpy), computed on `device`.

    The source mips are a box-filtered chain of the faces' mip 0 (the
    reference samples the skybox's full hardware mip chain)."""
    base = torch.as_tensor(
        np.stack([f.mip_array_rgba(0)[..., :3] for f in cubemap.faces]).astype(np.float32),
        device=device)
    n_src_mips = int(np.log2(base.shape[1])) + 1
    src = build_cubemap_mips(base, n_src_mips)
    return [m.cpu().numpy() for m in prefilter_env_map(src, out_size=out_size, **kw)]
