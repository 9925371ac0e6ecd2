"""CPU-side asset containers: MeshData, TextureData, CubeMapTextureData —
the port's copy of the JAX package's `resource/storage.py`, unchanged.

Numpy-backed equivalents of `Engine/Include/Resource/BasicStorage.h`. The
serialized binary layout (via `serialization.py`) is byte-identical to the
reference's reflection-driven format, including the BC-compressed texture
payloads (BasicStorage.cpp:161-188).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from . import bc
from .formats import (
    ETextureFormat,
    calc_texture_size,
    channel_count,
    numpy_dtype,
    pixel_size,
)


class EVertexFormat(enum.IntEnum):
    NONE = 0
    P3F_T2F = 1
    P3F_N3F_T3F_C3F_T2F = 2  # pos, normal, tangent, color, uv — 56 bytes


VERTEX_STRIDE = {
    EVertexFormat.P3F_T2F: 20,
    EVertexFormat.P3F_N3F_T3F_C3F_T2F: 56,
}

# numpy structured dtypes mirroring Resource/VertexLayout.h
STANDARD_VERTEX_DTYPE = np.dtype(
    [
        ("position", np.float32, 3),
        ("normal", np.float32, 3),
        ("tangent", np.float32, 3),
        ("color", np.float32, 3),
        ("uv", np.float32, 2),
    ]
)
P3F_T2F_DTYPE = np.dtype([("position", np.float32, 3), ("uv", np.float32, 2)])

VERTEX_DTYPE = {
    EVertexFormat.P3F_T2F: P3F_T2F_DTYPE,
    EVertexFormat.P3F_N3F_T3F_C3F_T2F: STANDARD_VERTEX_DTYPE,
}


@dataclass
class SubMeshData:
    index: int = 0
    indices_count: int = 0


class MeshData:
    """Vertex/index blobs + submesh ranges + AABB (BasicStorage.h:87-183)."""

    def __init__(
        self,
        vertex_format: EVertexFormat = EVertexFormat.NONE,
        vertices: bytes = b"",
        indices: bytes = b"",
        sub_meshes: list[SubMeshData] | None = None,
        bound_min=None,
        bound_max=None,
    ):
        self.vertex_format = EVertexFormat(vertex_format)
        self.vertices = bytes(vertices)
        self.indices = bytes(indices)
        self.sub_meshes = sub_meshes or []
        self.bound_min = np.asarray(
            bound_min if bound_min is not None else [0, 0, 0], dtype=np.float32
        )
        self.bound_max = np.asarray(
            bound_max if bound_max is not None else [0, 0, 0], dtype=np.float32
        )

    @classmethod
    def from_arrays(
        cls,
        vertex_format: EVertexFormat,
        vertices: np.ndarray,
        indices: np.ndarray,
        sub_meshes: list[SubMeshData] | None = None,
        bound_min=None,
        bound_max=None,
    ) -> "MeshData":
        idx = np.ascontiguousarray(indices, dtype=np.uint32)
        if sub_meshes is None:
            sub_meshes = [SubMeshData(0, int(idx.size))]
        return cls(
            vertex_format,
            np.ascontiguousarray(vertices).tobytes(),
            idx.tobytes(),
            sub_meshes,
            bound_min,
            bound_max,
        )

    @property
    def vertex_stride(self) -> int:
        return VERTEX_STRIDE[self.vertex_format]

    @property
    def vertex_count(self) -> int:
        return len(self.vertices) // self.vertex_stride

    @property
    def index_count(self) -> int:
        return len(self.indices) // 4

    def vertex_array(self) -> np.ndarray:
        """Structured array view of the vertex blob."""
        return np.frombuffer(self.vertices, dtype=VERTEX_DTYPE[self.vertex_format])

    def index_array(self) -> np.ndarray:
        return np.frombuffer(self.indices, dtype=np.uint32)


class TextureData:
    """2D texture mip chain (BasicStorage.h:241-303).

    `data` is the raw (uncompressed) tightly-packed mip chain; BC compression
    happens only on (de)serialization, like the reference.
    """

    def __init__(
        self,
        width: int = 0,
        height: int = 0,
        mip_levels: int = 0,
        fmt: ETextureFormat = ETextureFormat.NONE,
        data: bytes | None = None,
        depth: int = 1,
    ):
        self.width = int(width)
        self.height = int(height)
        self.depth = int(depth)
        self.mip_levels = int(mip_levels)
        self.format = ETextureFormat(fmt)
        if data is None and width:
            data = bytes(calc_texture_size(width, height, mip_levels, pixel_size(fmt)))
        self.data = data or b""
        if self.width:
            expected = calc_texture_size(
                self.width, self.height, self.mip_levels, pixel_size(self.format)
            )
            assert len(self.data) == expected, (
                f"texture blob size {len(self.data)} != expected {expected}"
            )

    @classmethod
    def from_array(cls, mip0: np.ndarray, fmt: ETextureFormat, gen_mips: bool = True) -> "TextureData":
        """Build a texture (optionally with a full mip chain) from an (H, W, C) array."""
        from .mipmap import generate_mip_chain  # local import to avoid cycle

        return generate_mip_chain(mip0, fmt) if gen_mips else cls.from_mips([mip0], fmt)

    @classmethod
    def from_mips(cls, mips: list[np.ndarray], fmt: ETextureFormat) -> "TextureData":
        h, w = mips[0].shape[:2]
        blob = b"".join(np.ascontiguousarray(m).tobytes() for m in mips)
        return cls(w, h, len(mips), fmt, blob)

    @property
    def pixel_size(self) -> int:
        return pixel_size(self.format)

    @property
    def channels(self) -> int:
        return channel_count(self.format)

    def mip_array(self, mip: int = 0) -> np.ndarray:
        """(h, w, channels) numpy view of one mip level."""
        from .formats import calc_mipmap_layout

        layout = calc_mipmap_layout(
            self.width, self.height, self.mip_levels, self.pixel_size, mip
        )
        dt = numpy_dtype(self.format)
        arr = np.frombuffer(
            self.data, dtype=dt, count=layout.width * layout.height * self.channels,
            offset=layout.base_offset,
        )
        return arr.reshape(layout.height, layout.width, self.channels)

    def mip_arrays(self) -> list[np.ndarray]:
        return [self.mip_array(i) for i in range(self.mip_levels)]

    def mip_array_rgba(self, mip: int = 0) -> np.ndarray:
        """Mip pixels with channels in RGBA order regardless of storage order
        (BGRA formats are swizzled); single/dual channel formats are returned
        as-is. sRGB linearization is NOT applied here — the shading path does
        that (matching the D3D sampler)."""
        from .formats import is_bgra

        m = self.mip_array(mip)
        if is_bgra(self.format):
            return m[..., [2, 1, 0, 3]]
        return m

    def sample_nearest(self, u: float, v: float) -> np.ndarray:
        """TextureData::Sample semantics (BasicStorage.cpp:126-142): nearest
        texel of mip 0, u->column, v->row, clamped."""
        m = self.mip_array(0)
        x = int(np.clip(int(u * self.width), 0, self.width - 1))
        y = int(np.clip(int(v * self.height), 0, self.height - 1))
        px = m[y, x].astype(np.float32)
        out = np.zeros(4, np.float32)
        out[: self.channels] = px[: self.channels]
        return out

    # -- custom binary serialization (BC compressed), see serialization.py --
    def compress_payload(self) -> bytes:
        return bc.compress_texture(
            self.width, self.height, self.mip_levels, self.format, self.data
        )

    @classmethod
    def from_compressed(
        cls, width: int, height: int, depth: int, mip_levels: int,
        fmt: ETextureFormat, payload: bytes,
    ) -> "TextureData":
        raw = bc.decompress_texture(width, height, mip_levels, fmt, payload)
        return cls(width, height, mip_levels, fmt, raw, depth=depth)


class CubeMapTextureData:
    """Six TextureData faces + baked SH coefficients (BasicStorage.h:305-329).

    Face order +X,-X,+Y,-Y,+Z,-Z (D3D cubemap convention).
    """

    def __init__(self, faces: list[TextureData] | None = None, sh_pack=None):
        self.faces = faces or [TextureData() for _ in range(6)]
        if sh_pack is None and faces is not None:
            from ..utils import sh as sh_mod

            sh_pack = sh_mod.generate_sh_coefficients(self)
        self.sh = sh_pack  # SH2CoefficientsPack (utils.sh) or None

    def face_arrays(self, mip: int = 0) -> np.ndarray:
        return np.stack([f.mip_array(mip) for f in self.faces])

    @property
    def size(self) -> int:
        return self.faces[0].width
