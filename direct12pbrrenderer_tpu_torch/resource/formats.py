"""Texture formats and mip-chain layout math — the port's copy of the JAX
package's `resource/formats.py`, unchanged.

Mirrors `Engine/Include/Resource/BasicStorage.h:12-27,207-238` (ETextureFormat
is a uint8 subset of DXGI_FORMAT; mip sizes are tightly packed, no row pitch
padding in the serialized blobs).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class ETextureFormat(enum.IntEnum):
    NONE = 0
    R32G32B32A32_TYPELESS = 1
    R32G32B32A32_FLOAT = 2
    R16G16B16A16_FLOAT = 10
    R16G16B16A16_UNORM = 11
    R32G32_SINT = 18
    R10G10B10A2_UNORM = 24
    R8G8B8A8_UNORM = 28
    R16G16_FLOAT = 34
    R16G16_UNORM = 35
    R8G8_UNORM = 49
    R8_UNORM = 61
    B8G8R8A8_UNORM = 87
    B8G8R8X8_UNORM = 88
    R8G8B8A8_UNORM_SRGB = 29
    B8G8R8A8_UNORM_SRGB = 91
    B8G8R8X8_UNORM_SRGB = 93
    DEPTH_STENCIL = 100


_PIXEL_SIZE = {
    ETextureFormat.R32G32B32A32_TYPELESS: 16,
    ETextureFormat.R32G32B32A32_FLOAT: 16,
    ETextureFormat.R16G16B16A16_FLOAT: 8,
    ETextureFormat.R16G16B16A16_UNORM: 8,
    ETextureFormat.R32G32_SINT: 8,
    ETextureFormat.R10G10B10A2_UNORM: 4,
    ETextureFormat.R8G8B8A8_UNORM: 4,
    ETextureFormat.R16G16_FLOAT: 4,
    ETextureFormat.R16G16_UNORM: 4,
    ETextureFormat.R8G8_UNORM: 2,
    ETextureFormat.R8_UNORM: 1,
}

_CHANNEL_COUNT = {
    ETextureFormat.R32G32B32A32_TYPELESS: 4,
    ETextureFormat.R32G32B32A32_FLOAT: 4,
    ETextureFormat.R16G16B16A16_FLOAT: 4,
    ETextureFormat.R16G16B16A16_UNORM: 4,
    ETextureFormat.R32G32_SINT: 2,
    ETextureFormat.R10G10B10A2_UNORM: 4,
    ETextureFormat.R8G8B8A8_UNORM: 4,
    ETextureFormat.R16G16_FLOAT: 2,
    ETextureFormat.R16G16_UNORM: 2,
    ETextureFormat.R8G8_UNORM: 2,
    ETextureFormat.R8_UNORM: 1,
}

_NUMPY_DTYPE = {
    ETextureFormat.R32G32B32A32_FLOAT: np.float32,
    ETextureFormat.R16G16B16A16_FLOAT: np.float16,
    ETextureFormat.R16G16B16A16_UNORM: np.uint16,
    ETextureFormat.R8G8B8A8_UNORM: np.uint8,
    ETextureFormat.R16G16_FLOAT: np.float16,
    ETextureFormat.R16G16_UNORM: np.uint16,
    ETextureFormat.R8G8_UNORM: np.uint8,
    ETextureFormat.R8_UNORM: np.uint8,
}


for _f in (
    ETextureFormat.B8G8R8A8_UNORM,
    ETextureFormat.B8G8R8X8_UNORM,
    ETextureFormat.R8G8B8A8_UNORM_SRGB,
    ETextureFormat.B8G8R8A8_UNORM_SRGB,
    ETextureFormat.B8G8R8X8_UNORM_SRGB,
):
    _PIXEL_SIZE[_f] = 4
    _CHANNEL_COUNT[_f] = 4
    _NUMPY_DTYPE[_f] = np.uint8


def is_bgra(fmt: ETextureFormat) -> bool:
    return fmt in (
        ETextureFormat.B8G8R8A8_UNORM,
        ETextureFormat.B8G8R8X8_UNORM,
        ETextureFormat.B8G8R8A8_UNORM_SRGB,
        ETextureFormat.B8G8R8X8_UNORM_SRGB,
    )


def is_srgb(fmt: ETextureFormat) -> bool:
    """sRGB SRVs are linearized by the sampler in D3D; shipped WIC imports
    store e.g. B8G8R8A8_UNORM_SRGB (91). The shading path must reproduce the
    hardware sRGB EOTF when sampling these."""
    return fmt in (
        ETextureFormat.R8G8B8A8_UNORM_SRGB,
        ETextureFormat.B8G8R8A8_UNORM_SRGB,
        ETextureFormat.B8G8R8X8_UNORM_SRGB,
    )


def pixel_size(fmt: ETextureFormat) -> int:
    return _PIXEL_SIZE[ETextureFormat(fmt)]


def channel_count(fmt: ETextureFormat) -> int:
    return _CHANNEL_COUNT[ETextureFormat(fmt)]


def numpy_dtype(fmt: ETextureFormat):
    return _NUMPY_DTYPE[ETextureFormat(fmt)]


def is_hdr_format(fmt: ETextureFormat) -> bool:
    """TextureCompressor::IsHDRFormat (TextureCompression.cpp:6-10): formats
    1..18 are compressed as BC6H, everything else as BC1."""
    return 1 <= int(fmt) <= 18


@dataclass(frozen=True)
class MipmapLayout:
    base_offset: int
    mip_size: int
    width: int
    height: int


def calc_texture_size(width: int, height: int, mip_levels: int, pix_size: int) -> int:
    size = 0
    for i in range(mip_levels):
        mw, mh = width >> i, height >> i
        assert mw > 0 and mh > 0, "mip_levels exceeds texture limits"
        size += mw * mh * pix_size
    return size


def calc_mipmap_layout(
    width: int, height: int, mip_levels: int, pix_size: int, mip_slice: int
) -> MipmapLayout:
    assert 0 <= mip_slice < mip_levels
    base = calc_texture_size(width, height, mip_slice, pix_size)
    mw, mh = width >> mip_slice, height >> mip_slice
    return MipmapLayout(base, mw * mh * pix_size, mw, mh)


def calc_max_mip_levels(width: int, height: int) -> int:
    return int(np.log2(min(width, height))) + 1
