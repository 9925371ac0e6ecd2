"""Textures: the albedo map's mip chain and its LinearWrap samplers, one for
each value of the pipeline's `texture_filter` (gbuffer.hlsl's implicit-LOD
Sample), and clamp-addressed cube and 2D samplers (the reference's
LinearClamp samplers).

* `trilinear`: the mip of the footprint's major axis, blended between the
  two nearest levels;
* `bilinear`: one bilinear sample of the level nearest that mip;
* `anisotropic`: the port's software filter, not a D3D12 anisotropic
  sampler, whose footprint the hardware chooses: `ANISO_TAPS` trilinear taps
  spread along the major gradient, the mip taken from the minor axis, the
  ratio capped at `ANISO_TAPS`, the taps summed in order and scaled by
  1 / `ANISO_TAPS`.
"""

from __future__ import annotations

import numpy as np
import torch

ANISO_TAPS = 4
# trilinear (or bilinear) samples of a mip chain that one texture sample takes
TAPS = {"trilinear": 1, "bilinear": 1, "anisotropic": ANISO_TAPS}


def mip_chain(rgba8: np.ndarray, max_dim: int | None) -> list[np.ndarray]:
    """2x2 box-filtered chain to 1x1 (DirectX GenerateMipMaps on powers of
    two), carried in float32 and re-quantized per level; levels larger than
    `max_dim` are dropped (the atlas starts lower)."""
    cur = rgba8.astype(np.float32)
    chain = [cur]
    while max(cur.shape[:2]) > 1:
        h, w = cur.shape[:2]
        nh, nw = max(1, h // 2), max(1, w // 2)
        cur = cur[:nh * 2, :nw * 2].reshape(nh, min(h, 2), nw, min(w, 2), -1).mean(axis=(1, 3))
        chain.append(cur)
    out = [np.clip(np.round(m), 0, 255).astype(np.uint8) for m in chain]
    return [m for m in out if max_dim is None or max(m.shape[:2]) <= max_dim]


def bilerp(c00, c01, c10, c11, fx, fy):
    return c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy) + c10 * (1 - fx) * fy + c11 * fx * fy


def srgb_eotf(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


class MipTexture:
    """An 8-bit RGBA mip chain on the device, sampled with wrap addressing."""

    def __init__(self, mips: list[np.ndarray], srgb: bool, device):
        self.n = len(mips)
        self.w = torch.tensor([m.shape[1] for m in mips], device=device)
        self.h = torch.tensor([m.shape[0] for m in mips], device=device)
        offs = np.cumsum([0] + [m.shape[0] * m.shape[1] for m in mips])[:-1]
        self.off = torch.tensor(offs, device=device)
        self.texels = torch.as_tensor(
            np.concatenate([m.reshape(-1, 4) for m in mips]), device=device).float() * (1.0 / 255.0)
        self.size = (float(mips[0].shape[1]), float(mips[0].shape[0]))
        self.srgb = srgb

    def bilinear(self, mip, u, v):
        mip = torch.minimum(mip, torch.tensor(self.n - 1, device=mip.device))
        w, h, off = self.w[mip], self.h[mip], self.off[mip]
        x = u * w.float() - 0.5
        y = v * h.float() - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0 = torch.remainder(x0.long(), w)
        y0 = torch.remainder(y0.long(), h)
        x1 = torch.remainder(x0 + 1, w)
        y1 = torch.remainder(y0 + 1, h)
        t = self.texels
        return bilerp(t[off + y0 * w + x0], t[off + y0 * w + x1], t[off + y1 * w + x0],
                      t[off + y1 * w + x1], fx, fy)

    def _clamp_lod(self, lod):
        return torch.minimum(torch.clamp(lod, min=0.0), torch.tensor(float(self.n - 1),
                                                                     device=lod.device))

    def _linear(self, c):
        if not self.srgb:
            return c
        return torch.cat([srgb_eotf(c[..., :3]), c[..., 3:]], -1)

    def trilinear(self, u, v, lod):
        """LinearWrap trilinear sample, sRGB-linearized where the format is."""
        lod = self._clamp_lod(lod)
        m0 = torch.floor(lod).long()
        frac = (lod - m0)[..., None]
        return self._linear(self.bilinear(m0, u, v) * (1 - frac)
                            + self.bilinear(m0 + 1, u, v) * frac)

    def nearest_mip(self, u, v, lod):
        """LinearWrap bilinear sample of mip round(lod) (halves to even),
        sRGB-linearized where the format is: the `bilinear` filter."""
        return self._linear(self.bilinear(torch.round(self._clamp_lod(lod)).long(), u, v))

    def anisotropic(self, uv, ddx, ddy, mask):
        """The software anisotropic filter (module docstring) at uv (..., 2)
        with quad derivatives ddx, ddy (..., 2) in uv units; lod 99 (the
        last mip) where `mask` is False."""
        size = torch.tensor(self.size, device=uv.device)
        gx, gy = ddx * size, ddy * size
        rx2, ry2 = (gx * gx).sum(-1), (gy * gy).sum(-1)
        rho2 = torch.maximum(rx2, ry2)
        rho_min2 = torch.clamp(torch.minimum(rx2, ry2), min=1e-12)
        ratio = torch.clamp(torch.sqrt(rho2 / rho_min2), 1.0, float(ANISO_TAPS))
        lod = 0.5 * torch.log2(torch.clamp(rho2, min=1e-12)) - torch.log2(ratio)
        lod = torch.where(mask, lod, 99.0)
        major = torch.where((rx2 >= ry2)[..., None], ddx, ddy)
        acc = None
        for i in range(ANISO_TAPS):
            tap = uv + major * ((i + 0.5) / ANISO_TAPS - 0.5)
            c = self.trilinear(tap[..., 0], tap[..., 1], lod)
            acc = c if acc is None else acc + c
        return acc * (1.0 / ANISO_TAPS)


def cube_coords(dirs):
    """(..., 3) directions -> (face, u, v); x wins ties strictly, then y, else z."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax > ay) & (ax > az)
    is_y = (~is_x) & (ay > ax) & (ay > az)
    inv = 1.0 / torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-6)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    u = torch.where(is_x, torch.where(x > 0, -z, z) * inv,
                    torch.where(is_y, x * inv, torch.where(z > 0, x, -x) * inv))
    v = torch.where(is_x, -y * inv, torch.where(is_y, torch.where(y > 0, z, -z) * inv, -y * inv))
    return face.long(), (u + 1.0) * 0.5, (v + 1.0) * 0.5


class CubeMips:
    """A float cube mip chain, bilinear per face with clamp addressing
    (no seam blending), trilinear across mips."""

    def __init__(self, mips: list[torch.Tensor]):
        dev = mips[0].device
        self.n = len(mips)
        self.size = torch.tensor([m.shape[1] for m in mips], device=dev)
        offs = np.cumsum([0] + [6 * m.shape[1] * m.shape[2] for m in mips])[:-1]
        self.off = torch.tensor(offs, device=dev)
        self.flat = torch.cat([m.reshape(-1, m.shape[-1]) for m in mips])

    def bilinear(self, dirs, mip):
        face, u, v = cube_coords(dirs)
        size = self.size[mip]
        off = self.off[mip]
        sizef = size.to(dirs.dtype)
        hi = (size - 1).to(dirs.dtype)
        x = u * sizef - 0.5
        y = v * sizef - 0.5
        x0 = torch.clamp(torch.clamp(torch.floor(x), min=0.0), max=hi).long()
        y0 = torch.clamp(torch.clamp(torch.floor(y), min=0.0), max=hi).long()
        fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
        fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
        x1 = torch.minimum(x0 + 1, size - 1)
        y1 = torch.minimum(y0 + 1, size - 1)
        base = off + face * size * size
        f = self.flat
        return bilerp(f[base + y0 * size + x0], f[base + y0 * size + x1],
                      f[base + y1 * size + x0], f[base + y1 * size + x1], fx, fy)

    def trilinear(self, dirs, level):
        lvl = torch.clamp(level, 0.0, self.n - 1.0)
        lo = torch.floor(lvl).long()
        frac = (lvl - lo)[..., None]
        hi = torch.clamp(lo + 1, max=self.n - 1)
        return self.bilinear(dirs, lo) * (1 - frac) + self.bilinear(dirs, hi) * frac


def sample_2d_clamp(tex, u, v):
    """Bilinear clamp sample of an (h, w, c) tensor at uv."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.clamp(torch.floor(x), 0, w - 1).long()
    y0 = torch.clamp(torch.floor(y), 0, h - 1).long()
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    return bilerp(tex[y0, x0], tex[y0, x1], tex[y1, x0], tex[y1, x1], fx, fy)
