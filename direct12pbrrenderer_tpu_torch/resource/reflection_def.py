"""Reflected field definitions, mirroring `Utils/ReflectionDef.h` 1:1; the
port's copy of the JAX package's `resource/reflection_def.py`, unchanged.

Attaches CPP_NAME / BASE / FIELDS metadata and custom binary hooks to the
storage classes so the generic serializers reproduce the reference's exact
byte/JSON layouts.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.sh import SH2CoefficientsPack
from .formats import ETextureFormat
from .serialization import FieldSpec, Reader
from .storage import CubeMapTextureData, MeshData, SubMeshData, TextureData

# --- SubMeshData (ReflectionDef.h:55-58) -----------------------------------
SubMeshData.CPP_NAME = "SubMeshData"
SubMeshData.FIELDS = (
    FieldSpec("Index", "index", "u32"),
    FieldSpec("IndicesCount", "indices_count", "u32"),
)


def _submesh_init(obj):
    obj.index = 0
    obj.indices_count = 0


SubMeshData.init_defaults = _submesh_init


# --- MeshData (ReflectionDef.h:60-66) ---------------------------------------
# Generic reflection in the reference; custom hooks here only because our
# attribute layout differs (bound as two arrays instead of an AABB object).

def _mesh_bin_ser(obj: MeshData, out: bytearray) -> None:
    out += struct.pack("<I", int(obj.vertex_format))
    out += np.asarray(obj.bound_min, np.float32).tobytes()
    out += np.asarray(obj.bound_max, np.float32).tobytes()
    out += struct.pack("<I", len(obj.vertices)) + obj.vertices
    out += struct.pack("<I", len(obj.indices)) + obj.indices
    out += struct.pack("<I", len(obj.sub_meshes))
    for sm in obj.sub_meshes:
        out += struct.pack("<II", sm.index, sm.indices_count)


def _mesh_bin_deser(r: Reader) -> MeshData:
    fmt = r.u32()
    bmin = np.frombuffer(r.read(12), np.float32).copy()
    bmax = np.frombuffer(r.read(12), np.float32).copy()
    verts = bytes(r.read(r.u32()))
    idx = bytes(r.read(r.u32()))
    n = r.u32()
    subs = [SubMeshData(r.u32(), r.u32()) for _ in range(n)]
    return MeshData(fmt, verts, idx, subs, bmin, bmax)


MeshData.CPP_NAME = "MeshData"
MeshData.binary_serialize_custom = _mesh_bin_ser
MeshData.binary_deserialize_custom = staticmethod(_mesh_bin_deser)


# --- TextureData (BasicStorage.cpp:161-188, custom in the reference too) ----

def _tex_bin_ser(obj: TextureData, out: bytearray) -> None:
    # TextureInfo via generic reflection: Width/Height/Depth/MipLevels u16,
    # Format reflected-enum -> u32 (the trailing _Padding bytes are not
    # reflected and therefore not serialized).
    out += struct.pack(
        "<HHHHI", obj.width, obj.height, obj.depth, obj.mip_levels, int(obj.format)
    )
    payload = obj.compress_payload()
    out += struct.pack("<I", len(payload)) + payload


def _tex_bin_deser(r: Reader) -> TextureData:
    w, h, d, mips, fmt = struct.unpack("<HHHHI", r.read(12))
    payload = r.read(r.u32())
    return TextureData.from_compressed(w, h, d, mips, ETextureFormat(fmt), payload)


TextureData.CPP_NAME = "TextureData"
TextureData.binary_serialize_custom = _tex_bin_ser
TextureData.binary_deserialize_custom = staticmethod(_tex_bin_deser)


# --- SH pack (ReflectionDef.h:45-53) ----------------------------------------
SH2CoefficientsPack.CPP_NAME = "SH2CoefficientsPack"
SH2CoefficientsPack.FIELDS = tuple(
    FieldSpec(n, n, "vec4")
    for n in ("sha_r", "shb_r", "sha_g", "shb_g", "sha_b", "shb_b", "shc")
)


# --- CubeMapTextureData (ReflectionDef.h:81-84) ------------------------------

def _cube_bin_ser(obj: CubeMapTextureData, out: bytearray) -> None:
    for face in obj.faces:
        _tex_bin_ser(face, out)
    pack = obj.sh if obj.sh is not None else SH2CoefficientsPack()
    out += pack.as_array().tobytes()


def _cube_bin_deser(r: Reader) -> CubeMapTextureData:
    faces = [_tex_bin_deser(r) for _ in range(6)]
    pack = SH2CoefficientsPack.from_array(np.frombuffer(r.read(7 * 16), np.float32))
    return CubeMapTextureData(faces=faces, sh_pack=pack)


CubeMapTextureData.CPP_NAME = "CubeMapTextureData"
CubeMapTextureData.binary_serialize_custom = _cube_bin_ser
CubeMapTextureData.binary_deserialize_custom = staticmethod(_cube_bin_deser)
