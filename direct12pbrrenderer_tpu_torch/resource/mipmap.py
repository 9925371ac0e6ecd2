"""Mip-chain generation (DirectXTex GenerateMipMaps equivalent) — the port's
copy of the JAX package's `resource/mipmap.py`.

The reference generates full mip chains at import time with
`DirectX::GenerateMipMaps(..., TEX_FILTER_DEFAULT)` (ResourceLoader.cpp:465).
We use a 2x2 box filter per level (the effective default for power-of-two
images), carried out in float32 and re-quantized per format.
"""

from __future__ import annotations

import numpy as np

from .formats import ETextureFormat, calc_max_mip_levels, numpy_dtype
from .storage import TextureData


def _box_downsample(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    nh, nw = max(1, h // 2), max(1, w // 2)
    img = img[: nh * 2, : nw * 2]
    if h >= 2 and w >= 2:
        return (
            img.reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3)).reshape(nh, nw, img.shape[-1])
        )
    if h >= 2:
        return img.reshape(nh, 2, 1, -1).mean(axis=1).reshape(nh, nw, img.shape[-1])
    if w >= 2:
        return img.reshape(1, nw, 2, -1).mean(axis=2).reshape(nh, nw, img.shape[-1])
    return img


def _quantize(img_f32: np.ndarray, fmt: ETextureFormat) -> np.ndarray:
    dt = numpy_dtype(fmt)
    if dt == np.uint8:
        return np.clip(np.round(img_f32), 0, 255).astype(np.uint8)
    if dt == np.uint16:
        return np.clip(np.round(img_f32), 0, 65535).astype(np.uint16)
    return img_f32.astype(dt)


def generate_mip_chain(
    mip0: np.ndarray, fmt: ETextureFormat, mip_levels: int | None = None
) -> TextureData:
    """(H, W, C) array -> TextureData with a full (or `mip_levels`-deep) chain."""
    h, w = mip0.shape[:2]
    if mip0.ndim == 2:
        mip0 = mip0[..., None]
    levels = mip_levels or calc_max_mip_levels(w, h)
    cur = mip0.astype(np.float32)
    mips = [_quantize(cur, fmt)]
    for _ in range(levels - 1):
        cur = _box_downsample(cur)
        mips.append(_quantize(cur, fmt))
    return TextureData.from_mips(mips, fmt)
