"""Deferred G-buffer pass — counterpart of `ops/gbuffer.py`.

The pixel-shader half of `gbuffer.hlsl` (ps_main, :89-148) over the whole
frame after visibility: perspective-correct attribute interpolation, texture
sampling with quad-difference LOD and sRGB linearization, TBN normal mapping,
gamma decode, octahedral encode and RGBA8 quantization. Three samplers, as in
the JAX package: the direct-atlas LinearWrap sampler (trilinear or
bilinear), the software anisotropic filter (four trilinear taps along the
major gradient), and the texture cache (`ops/texcache.py`: the plan with
kernel B or I, the resolve with kernel E on the planar path or kernel C on
the fused one). G-buffer layouts are the JAX package's: A (H, W, 4), B (H,
W, 2), C (H, W, 3), depth (H, W), mask (H, W).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import common, raster


class AtlasDevice(NamedTuple):
    data: torch.Tensor        # (N, 4) int32: the uint32 quad records' bits (scene_pack)
    page_base: torch.Tensor   # (T, MAX_MIPS) int32 page offsets
    base_size: torch.Tensor   # (T, 2) int32
    n_mips: torch.Tensor      # (T,) int32
    srgb: torch.Tensor        # (T,) bool

    @classmethod
    def from_numpy(cls, data, page_base, base_size, n_mips, srgb, device) -> "AtlasDevice":
        """uint32 records are stored as int32 bit patterns (torch has no
        general uint32 arithmetic); _unpack_rgba masks bytes either way."""
        data = np.array(data, dtype=np.uint32).view(np.int32)
        return cls(*(torch.as_tensor(np.array(a), device=device)
                     for a in (data, page_base, base_size, n_mips, srgb)))


def pack_material_rows(albedo, emission, roughness, metallic, use_map, tex_ids):
    """(M, 16) material rows: [albedo(3), emission, roughness, metallic,
    use(5), tex(5)] — the ConstantBufferInstance block. Host-side numpy."""
    m = len(emission)
    rows = np.zeros((m, 16), np.float32)
    rows[:, 0:3] = albedo
    rows[:, 3] = emission
    rows[:, 4] = roughness
    rows[:, 5] = metallic
    rows[:, 6:11] = use_map.astype(np.float32)
    rows[:, 11:16] = tex_ids.astype(np.float32)  # exact for ids < 2^24
    return rows


def pack_vertex_attrs(uvs, normals_ws, tangents_ws):
    """(V, 8): [uv(2), normal(3), tangent(3)] — one contiguous row per vertex."""
    return torch.cat([uvs, normals_ws, tangents_ws], dim=1)


def _unpack_rgba(u32):
    r = (u32 & 0xFF).float()
    g = ((u32 >> 8) & 0xFF).float()
    b = ((u32 >> 16) & 0xFF).float()
    a = ((u32 >> 24) & 0xFF).float()
    return torch.stack([r, g, b, a], -1) * (1.0 / 255.0)


def page_record_index(page_base, w, x0, y0):
    """Flat record index of wrapped texel (x0, y0) in the page-major layout
    (16x8-texel pages, 128 records each; see scene_pack.TextureAtlas)."""
    pages_x = (w + 15) >> 4
    page = page_base + (y0 >> 3) * pages_x + (x0 >> 4)
    return page * 128 + (y0 & 7) * 16 + (x0 & 15)


def _sample_mip_bilinear(atlas: AtlasDevice, tex_id, mip, u, v):
    """Bilinear wrap sample of one mip: one 16-byte quad-record gather per tap."""
    mip = torch.minimum(mip, atlas.n_mips[tex_id].long() - 1)
    w = torch.clamp(atlas.base_size[tex_id, 0].long() >> mip, min=1)
    h = torch.clamp(atlas.base_size[tex_id, 1].long() >> mip, min=1)
    off = atlas.page_base[tex_id, mip].long()

    x = u * w.float() - 0.5
    y = v * h.float() - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = torch.remainder(x0.long(), w)
    y0 = torch.remainder(y0.long(), h)

    quad = atlas.data[page_record_index(off, w, x0, y0)]
    return common.bilerp(_unpack_rgba(quad[..., 0]), _unpack_rgba(quad[..., 1]),
                          _unpack_rgba(quad[..., 2]), _unpack_rgba(quad[..., 3]), fx, fy)


def sample_atlas_raw(atlas: AtlasDevice, tex_id, u, v, lod, filter: str = "trilinear"):
    """LinearWrap mip filtering in storage space (no sRGB linearization)."""
    lod = torch.minimum(torch.clamp(lod, min=0.0), (atlas.n_mips[tex_id] - 1).float())
    if filter == "bilinear":
        return _sample_mip_bilinear(atlas, tex_id, torch.round(lod).long(), u, v)
    m0 = torch.floor(lod).long()
    frac = (lod - m0)[..., None]
    c0 = _sample_mip_bilinear(atlas, tex_id, m0, u, v)
    c1 = _sample_mip_bilinear(atlas, tex_id, m0 + 1, u, v)
    return c0 * (1 - frac) + c1 * frac


def apply_srgb(atlas: AtlasDevice, tex_id, c):
    """sRGB-EOTF linearization of the rgb channels where the SRV is *_SRGB."""
    lin = common.srgb_eotf(c[..., :3])
    rgb = torch.where(atlas.srgb[tex_id][..., None], lin, c[..., :3])
    return torch.cat([rgb, c[..., 3:]], -1)


def sample_atlas_trilinear(atlas: AtlasDevice, tex_id, u, v, lod, filter: str = "trilinear"):
    """LinearWrap mip filtering, sRGB-linearized when flagged."""
    return apply_srgb(atlas, tex_id, sample_atlas_raw(atlas, tex_id, u, v, lod, filter))


def sample_atlas_anisotropic(atlas: AtlasDevice, tex, uv, ddx, ddy, size5, mask,
                             n_taps: int = 4):
    """Software anisotropic filtering (sRGB-linearized where flagged): `n_taps`
    trilinear taps spread along the major-gradient axis, the mip chosen from
    the footprint's minor axis sharpened by the aniso ratio.

    tex (H, W, 5); uv (H, W, 2); ddx/ddy (H, W, 2) screen-space uv
    derivatives; size5 (H, W, 5, 2) texture dims; mask (H, W) coverage."""
    gx = ddx[..., None, :] * size5
    gy = ddy[..., None, :] * size5
    rx2 = (gx * gx).sum(-1)
    ry2 = (gy * gy).sum(-1)
    rho2 = torch.maximum(rx2, ry2)
    rho_min2 = torch.clamp(torch.minimum(rx2, ry2), min=1e-12)
    ratio = torch.clamp(torch.sqrt(rho2 / rho_min2), 1.0, float(n_taps))
    lod_a = 0.5 * torch.log2(torch.clamp(rho2, min=1e-12)) - torch.log2(ratio)
    lod_a = torch.where(mask[..., None], lod_a, 99.0)
    major = torch.where((rx2 >= ry2)[..., None], ddx[..., None, :], ddy[..., None, :])
    acc = 0.0
    for i in range(n_taps):
        t = (i + 0.5) / n_taps - 0.5
        uv_i = uv[..., None, :] + major * t
        acc = acc + sample_atlas_trilinear(atlas, tex, uv_i[..., 0], uv_i[..., 1], lod_a,
                                           filter="trilinear")
    return acc * (1.0 / n_taps)


def _quad_derivatives(img):
    """2x2-quad screen derivatives like hardware ddx/ddy. img: (H, W, C) ->
    (ddx, ddy) with both pixels of a quad pair sharing the difference."""
    h, w = img.shape[0], img.shape[1]
    pairs_x = img.reshape(h, w // 2, 2, -1)
    dx = (pairs_x[:, :, 1] - pairs_x[:, :, 0])[:, :, None, :]
    ddx = dx.expand(pairs_x.shape).reshape(img.shape)
    pairs_y = img.reshape(h // 2, 2, w, -1)
    dy = (pairs_y[:, 1] - pairs_y[:, 0])[:, None, :, :]
    ddy = dy.expand(pairs_y.shape).reshape(img.shape)
    return ddx, ddy


class GBuffer(NamedTuple):
    albedo_emission: torch.Tensor  # (H, W, 4) "GBufferA"
    normal_oct: torch.Tensor       # (H, W, 2) "GBufferB".rg
    rough_metal_ao: torch.Tensor   # (H, W, 3) "GBufferC".rgb
    depth: torch.Tensor            # (H, W) ndc z
    mask: torch.Tensor             # (H, W) bool coverage (stencil != 0 analog)
    tex_approx: torch.Tensor | None = None  # cache taps resolved via fallback; None
    # on the direct-atlas and anisotropic sampler paths


def _quantize8(x):
    """RGBA8 render-target quantization (round to nearest 1/255)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) * (1.0 / 255.0)


def gbuffer_shade(tri_id, depth, tri_rows, atlas: AtlasDevice, width: int, height: int,
                  y_offset=0, texture_filter: str = "trilinear", use_tex_kernel: bool = False,
                  tex_caps: tuple | None = None, tex_cascade=False) -> GBuffer:
    """G-buffer from the rasterized id map + the packed (T, 64) triangle rows
    (the gather path: one row gather per pixel)."""
    interp, matrow, mask = interp_from_rows(tri_id, tri_rows, width, height, y_offset)
    return _shade_from_interp(interp, matrow, mask, depth, atlas, texture_filter,
                              use_tex_kernel, tex_caps, tex_cascade)


def interp_from_rows(tri_id, tri_rows, width, height, y_offset=0):
    """Per-pixel (interpolants (H, W, 8), material row (H, W, 16), mask)."""
    mask = tri_id >= 0
    tid = torch.clamp(tri_id, min=0).long()
    dev = tri_rows.device
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None] + y_offset
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    px, py = torch.broadcast_tensors(px, py)
    row = tri_rows[tid]  # (H, W, 64)
    _, lam_p, _ = _bary(row, px, py)
    attrs = row[..., 32:56].reshape(*row.shape[:-1], 3, 8)
    w = attrs * lam_p[..., None]
    interp = (w[..., 0, :] + w[..., 1, :]) + w[..., 2, :]
    return interp, row[..., 16:32], mask


def _cascade_kw(tex_cascade):
    """tex_cascade knob: False/True, or a (cap, block_cap, mip_off) tuple
    that both enables the LOD cascade and sizes it."""
    if isinstance(tex_cascade, tuple):
        return {"cascade": True, "cascade_caps": tex_cascade}
    return {"cascade": bool(tex_cascade)}


def _cap_kw(tex_caps):
    """tex_caps: (cap_lo, cap_hi[, stage_budget[, block_cap]]); None entries
    keep the worst-case defaults."""
    if tex_caps is None:
        return {}
    kw = {"cap_lo": tex_caps[0], "cap_hi": tex_caps[1]}
    for i, name in ((2, "stage_budget"), (3, "block_cap")):
        if len(tex_caps) > i and tex_caps[i] is not None:
            kw[name] = tex_caps[i]
    return kw


def gbuffer_shade_fused(tri_id, depth, pl_tiles, id_tiles, atlas: AtlasDevice, height: int,
                        width: int, tile_h: int, tile_w: int,
                        texture_filter: str = "trilinear", tex_caps: tuple | None = None,
                        tex_cascade=False, return_tiled: bool = False):
    """G-buffer straight from the raster kernel's tile blocks: plan, resolve
    and pixel shade run tiled (texcache.shade_planes_fused, kernels B and C);
    the one (H, W) materialization is the final 9-channel untile.

    return_tiled=True returns (GBuffer, gb_tiles (tiles, 9, blocks, 128)):
    the fused deferred pass reads the tile blocks directly."""
    from . import texcache

    gb_tiles, approx_count = texcache.shade_planes_fused(
        atlas, pl_tiles, id_tiles, height, width, tile_h, tile_w, filter=texture_filter,
        return_tiled=True, **_cascade_kw(tex_cascade), **_cap_kw(tex_caps))
    gb9 = texcache._untile(gb_tiles, height, width, tile_h, tile_w)
    gb = GBuffer(gb9[0:4].permute(1, 2, 0), gb9[4:6].permute(1, 2, 0),
                 gb9[6:9].permute(1, 2, 0), depth, tri_id >= 0, approx_count)
    return (gb, gb_tiles) if return_tiled else gb


def gbuffer_shade_planar(tri_id, depth, planes, atlas: AtlasDevice,
                         texture_filter: str = "trilinear", use_tex_kernel: bool = False,
                         tex_caps: tuple | None = None, tex_cascade=False) -> GBuffer:
    """G-buffer from the raster+interpolation kernel's (24, H, W) planes —
    no per-pixel attribute gathers, only the texture taps remain."""
    mask = tri_id >= 0
    interp = planes[0:8].permute(1, 2, 0)
    matrow = planes[8:24].permute(1, 2, 0)
    return _shade_from_interp(interp, matrow, mask, depth, atlas, texture_filter,
                              use_tex_kernel, tex_caps, tex_cascade)


def tap_lod(uv, tex, mask, atlas: AtlasDevice, use_tex_kernel: bool = True):
    """Per-slot mip LOD from the pixel-quad uv derivatives (gbuffer.hlsl's
    implicit Sample LOD): (ddx, ddy, size5, lod5). The texture dims are one
    indexed load either way; with use_tex_kernel a tex id outside the table
    reads a zero row, as the TPU's one-hot lookup does (both exact)."""
    ddx, ddy = _quad_derivatives(uv)
    if use_tex_kernel:
        from . import texcache

        size5 = texcache.onehot_lookup(atlas.base_size.float(), tex)   # (H, W, 5, 2)
    else:
        size5 = atlas.base_size[tex].float()
    gx = ddx[..., None, :] * size5
    gy = ddy[..., None, :] * size5
    rx2 = (gx * gx).sum(-1)
    ry2 = (gy * gy).sum(-1)
    rho2 = torch.maximum(rx2, ry2)
    lod5 = 0.5 * torch.log2(torch.clamp(rho2, min=1e-12))
    lod5 = torch.where(mask[..., None], lod5, 99.0)  # background -> last mip
    return ddx, ddy, size5, lod5


def tap_query(interp, matrow, mask, atlas: AtlasDevice, use_tex_kernel: bool = True):
    """(tex (H, W, 5) int32, u, v, lod5, active) exactly as the texture-cache
    path samples them: the front end of `texcache.tap_census`, next to the
    shade path so the two cannot drift."""
    interp = torch.where(mask[..., None], interp, 0.0)
    uv = interp[..., 0:2]
    use = matrow[..., 6:11] > 0.5
    tex = torch.clamp(matrow[..., 11:16].to(torch.int32), min=0)
    _, _, _, lod5 = tap_lod(uv, tex, mask, atlas, use_tex_kernel)
    return tex, uv[..., 0], uv[..., 1], lod5, use & mask[..., None]


def _shade_from_interp(interp, matrow, mask, depth, atlas: AtlasDevice,
                       texture_filter: str = "trilinear", use_tex_kernel: bool = False,
                       tex_caps: tuple | None = None, tex_cascade=False) -> GBuffer:
    # background pixels carry garbage interpolants -> pin them to one texel
    interp = torch.where(mask[..., None], interp, 0.0)
    uv = interp[..., 0:2]
    nrm = common.normalize(interp[..., 2:5], 1e-20)
    tan = common.normalize(interp[..., 5:8], 1e-20)

    mat_albedo = matrow[..., 0:3]
    mat_emission = matrow[..., 3]
    mat_roughness = matrow[..., 4]
    mat_metallic = matrow[..., 5]
    use = matrow[..., 6:11] > 0.5
    tex = torch.clamp(matrow[..., 11:16].to(torch.int64), min=0)

    ddx, ddy, size5, lod5 = tap_lod(uv, tex, mask, atlas, use_tex_kernel)
    approx_count = None
    if texture_filter == "anisotropic":
        samples = sample_atlas_anisotropic(atlas, tex, uv, ddx, ddy, size5, mask)
    elif use_tex_kernel:
        from . import texcache

        samples, approx = texcache.sample_atlas_textured(
            atlas, tex.to(torch.int32), uv[..., 0], uv[..., 1], lod5,
            active=use & mask[..., None], filter=texture_filter,
            **_cascade_kw(tex_cascade), **_cap_kw(tex_caps))
        approx_count = approx.sum().to(torch.int32)
    else:
        samples = sample_atlas_trilinear(atlas, tex, uv[..., 0:1], uv[..., 1:2], lod5,
                                         filter=texture_filter)   # (H, W, 5, 4)
    albedo_tex = samples[..., 0, :3]
    normal_tex = samples[..., 1, :3]
    metallic_tex = samples[..., 2, 0]
    roughness_tex = samples[..., 3, 0]
    ao_tex = samples[..., 4, 0]

    # normal mapping: TBN with bitangent = cross(N, T) (gbuffer.hlsl:63-69)
    bit = torch.linalg.cross(nrm, tan, dim=-1)
    n_ts = normal_tex * 2.0 - 1.0
    n_mapped = tan * n_ts[..., 0:1] + bit * n_ts[..., 1:2] + nrm * n_ts[..., 2:3]
    n_mapped = common.normalize(n_mapped, 1e-20)
    normal_ws = torch.where(use[..., 1:2], n_mapped, nrm)

    albedo = torch.where(use[..., 0:1], common.decode_gamma(albedo_tex),
                         common.decode_gamma(mat_albedo))
    roughness = torch.where(use[..., 3], roughness_tex, mat_roughness)
    metallic = torch.where(use[..., 2], metallic_tex, mat_metallic)
    # AO defaults to 0 when unmapped (gbuffer.hlsl:135-138) — reference quirk
    ao = torch.where(use[..., 4], ao_tex, 0.0)

    oct = common.encode_octahedron(normal_ws)
    gb_a = _quantize8(torch.cat([albedo, mat_emission[..., None]], -1))
    gb_b = _quantize8(oct)
    gb_c = _quantize8(torch.stack([roughness, metallic, ao], -1))

    m = mask[..., None]
    return GBuffer(torch.where(m, gb_a, 0.0), torch.where(m, gb_b, 0.0),
                   torch.where(m, gb_c, 0.0), depth, mask, approx_count)


def _bary(row, px, py):
    """Perspective-correct barycentrics from the gathered row: with
    homogeneous edge rows the edge scores B_i are the unnormalized
    perspective weights, lam = B / sum(B). Returns (None, lam, sum(B))."""
    e = row[..., :9].reshape(row.shape[:-1] + (3, 3))
    b = raster.edge_scores(px, py, e)
    sum_b = (b[0] + b[1]) + b[2]
    d = torch.where(sum_b == 0, 1.0, sum_b)
    return None, torch.stack([bi / d for bi in b], -1), sum_b
