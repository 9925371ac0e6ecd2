"""Reflection-style JSON + binary serialization, schema-compatible with the
reference engine; the port's copy of the JAX package's
`resource/serialization.py`, unchanged.

The reference drives serialization from compile-time reflection
(`Utils/Reflection.h`, `Utils/Serialization.h`): fields serialize in
declaration order, base-class first; JSON nests the base class under an
"@BaseName" key (Serialization.h:40-43,446-518); the binary format is a plain
little-endian concatenation (arithmetic fields raw, reflected enums as uint32,
vectors/strings as uint32 count + elements, std::array as bare elements,
BinaryData as uint32 size + bytes — BasicStorage.cpp:78-90).

Here each serializable class carries a declarative ``FieldSpec`` list (the
Python analog of REFLECT_FIELD), interpreted by the two generic serializers
below. Field lists mirror `Utils/ReflectionDef.h` exactly so that every asset
under the reference's Asset/ tree round-trips bit-for-bit.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# Field specs
# ---------------------------------------------------------------------------
# spec grammar:
#   "f32" "u8" "u16" "u32" "i32" "bool" "str"       scalars
#   "vec2" "vec3" "vec4"                            reflected Vector2/3/4
#   "enum"                                          reflected enum -> uint32
#   "binary"                                        BinaryData (u32 size + raw)
#   ("list", spec)                                  std::vector<spec>
#   ("array", spec, n)                              std::array<spec, n>
#   ("map", spec)                                   map<string, spec>
#   ("obj", cls)                                    nested reflected class
#   ("variant",)                                    ShaderParameter (JSON only)


@dataclass(frozen=True)
class FieldSpec:
    name: str          # reflected (JSON) name, e.g. "mMeshPath"
    attr: str          # python attribute name
    spec: Any
    serializable: bool = True


_SCALAR_FMT = {"f32": "<f", "u8": "<B", "u16": "<H", "u32": "<I", "i32": "<i", "bool": "<B"}


class Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        assert len(b) == n, "unexpected end of binary asset"
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack_from("<I", self.buf, self._adv(4))[0]

    def _adv(self, n: int) -> int:
        p = self.pos
        self.pos += n
        return p


# ---------------------------------------------------------------------------
# Binary
# ---------------------------------------------------------------------------

def binary_serialize(obj: Any, out: bytearray) -> None:
    cls = type(obj)
    custom = getattr(cls, "binary_serialize_custom", None)
    if custom is not None:
        custom(obj, out)
        return
    for base_or_self in _class_chain(cls):
        for f in base_or_self.__dict__.get("FIELDS", ()):  # own fields only
            if f.serializable:
                _bin_write(getattr(obj, f.attr), f.spec, out)
    post = getattr(obj, "post_serialized", None)
    if post:
        post()


def binary_deserialize(cls: type, r: Reader) -> Any:
    custom = getattr(cls, "binary_deserialize_custom", None)
    if custom is not None:
        return custom(r)
    obj = cls.__new__(cls)
    _init_defaults(obj, cls)
    for base_or_self in _class_chain(cls):
        for f in base_or_self.__dict__.get("FIELDS", ()):
            if f.serializable:
                setattr(obj, f.attr, _bin_read(f.spec, r))
    post = getattr(obj, "post_deserialized", None)
    if post:
        post()
    return obj


def _bin_write(val: Any, spec: Any, out: bytearray) -> None:
    if isinstance(spec, str):
        if spec in _SCALAR_FMT:
            out += struct.pack(_SCALAR_FMT[spec], int(val) if spec != "f32" else float(val))
        elif spec == "enum":
            out += struct.pack("<I", int(val))
        elif spec == "str":
            b = str(val).encode("utf-8")
            out += struct.pack("<I", len(b)) + b
        elif spec == "binary":
            b = bytes(val)
            out += struct.pack("<I", len(b)) + b
        elif spec in ("vec2", "vec3", "vec4"):
            n = {"vec2": 2, "vec3": 3, "vec4": 4}[spec]
            a = np.asarray(val, dtype=np.float32).reshape(n)
            out += a.tobytes()
        else:
            raise TypeError(f"unknown spec {spec}")
    elif spec[0] == "list":
        out += struct.pack("<I", len(val))
        for it in val:
            _bin_write(it, spec[1], out)
    elif spec[0] == "array":
        assert len(val) == spec[2]
        for it in val:
            _bin_write(it, spec[1], out)
    elif spec[0] == "obj":
        binary_serialize(val, out)
    else:
        raise TypeError(f"binary: unsupported spec {spec}")


def _bin_read(spec: Any, r: Reader) -> Any:
    if isinstance(spec, str):
        if spec in _SCALAR_FMT:
            fmt = _SCALAR_FMT[spec]
            v = struct.unpack(fmt, r.read(struct.calcsize(fmt)))[0]
            return bool(v) if spec == "bool" else v
        if spec == "enum":
            return struct.unpack("<I", r.read(4))[0]
        if spec == "str":
            n = r.u32()
            return r.read(n).decode("utf-8")
        if spec == "binary":
            n = r.u32()
            return bytes(r.read(n))
        if spec in ("vec2", "vec3", "vec4"):
            n = {"vec2": 2, "vec3": 3, "vec4": 4}[spec]
            return np.frombuffer(r.read(4 * n), dtype=np.float32).copy()
        raise TypeError(f"unknown spec {spec}")
    if spec[0] == "list":
        n = r.u32()
        assert n < 65535  # Serialization.h:119
        return [_bin_read(spec[1], r) for _ in range(n)]
    if spec[0] == "array":
        return [_bin_read(spec[1], r) for _ in range(spec[2])]
    if spec[0] == "obj":
        return binary_deserialize(spec[1], r)
    raise TypeError(f"binary: unsupported spec {spec}")


# ---------------------------------------------------------------------------
# JSON
# ---------------------------------------------------------------------------

def json_serialize(obj: Any) -> Any:
    """Object -> plain JSON structure; the most-derived class's fields sit at
    the top level with each base class nested under an "@BaseName" key."""
    return _json_write_class(obj, type(obj))


def _json_write_class(obj: Any, cls: type) -> dict:
    data: dict[str, Any] = {}
    base = getattr(cls, "BASE", None)
    if base is not None:
        data[f"@{base.CPP_NAME}"] = _json_write_class(obj, base)
    for f in cls.__dict__.get("FIELDS", ()):
        if f.serializable:
            data[f.name] = _json_write(getattr(obj, f.attr), f.spec)
    post = getattr(obj, "post_serialized", None)
    if post and cls is type(obj):
        post()
    return data


def json_deserialize(cls: type, data: dict, obj: Any | None = None) -> Any:
    if obj is None:
        obj = cls.__new__(cls)
        _init_defaults(obj, cls)
    _json_read_class(obj, cls, data)
    post = getattr(obj, "post_deserialized", None)
    if post:
        post()
    return obj


def _json_read_class(obj: Any, cls: type, data: dict) -> None:
    base = getattr(cls, "BASE", None)
    if base is not None:
        sub = data.get(f"@{base.CPP_NAME}")
        if isinstance(sub, dict):
            _json_read_class(obj, base, sub)
    for f in cls.__dict__.get("FIELDS", ()):
        if f.serializable and f.name in data:
            setattr(obj, f.attr, _json_read(f.spec, data[f.name]))


def _json_write(val: Any, spec: Any) -> Any:
    if isinstance(spec, str):
        if spec in ("f32",):
            return float(val)
        if spec in ("u8", "u16", "u32", "i32", "enum"):
            return int(val)
        if spec == "bool":
            return bool(val)
        if spec == "str":
            return str(val)
        if spec == "vec2":
            a = np.asarray(val, np.float32)
            return {"x": float(a[0]), "y": float(a[1])}
        if spec == "vec3":
            a = np.asarray(val, np.float32)
            return {"x": float(a[0]), "y": float(a[1]), "z": float(a[2])}
        if spec == "vec4":
            a = np.asarray(val, np.float32)
            return {"x": float(a[0]), "y": float(a[1]), "z": float(a[2]), "w": float(a[3])}
        if spec == "variant":
            return _variant_write(val)
        raise TypeError(f"json: unsupported spec {spec}")
    if spec[0] == "list":
        return [_json_write(it, spec[1]) for it in val]
    if spec[0] == "array":
        return [_json_write(it, spec[1]) for it in val]
    if spec[0] == "map":
        return {k: _json_write(v, spec[1]) for k, v in sorted(val.items())}
    if spec[0] == "obj":
        return _json_write_class(val, spec[1])
    raise TypeError(f"json: unsupported spec {spec}")


def _json_read(spec: Any, data: Any) -> Any:
    if isinstance(spec, str):
        if spec == "f32":
            return float(data)
        if spec in ("u8", "u16", "u32", "i32", "enum"):
            return int(data)
        if spec == "bool":
            return bool(data)
        if spec == "str":
            return str(data)
        if spec == "vec2":
            return np.array([data["x"], data["y"]], np.float32)
        if spec == "vec3":
            return np.array([data["x"], data["y"], data["z"]], np.float32)
        if spec == "vec4":
            return np.array([data["x"], data["y"], data["z"], data["w"]], np.float32)
        if spec == "variant":
            return _variant_read(data)
        raise TypeError(f"json: unsupported spec {spec}")
    if spec[0] == "list":
        return [_json_read(spec[1], it) for it in data]
    if spec[0] == "array":
        return [_json_read(spec[1], it) for it in data]
    if spec[0] == "map":
        return {k: _json_read(spec[1], v) for k, v in data.items()}
    if spec[0] == "obj":
        return json_deserialize(spec[1], data)
    raise TypeError(f"json: unsupported spec {spec}")


# ShaderParameter variant (IPipeline.cpp:206-247): bool | float | float[2|3|4]
def _variant_write(val: Any) -> Any:
    if isinstance(val, bool):
        return val
    if isinstance(val, (int, float)):
        return float(val)
    a = np.asarray(val, np.float32).ravel()
    return [float(x) for x in a]


def _variant_read(data: Any) -> Any:
    if isinstance(data, bool):
        return data
    if isinstance(data, (int, float)):
        return float(data)
    if isinstance(data, list):
        return np.asarray(data, np.float32)
    raise TypeError(f"bad ShaderParameter json: {data!r}")


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _class_chain(cls: type) -> list[type]:
    """[rootbase, ..., cls] — serialization order (base first)."""
    chain = []
    c: type | None = cls
    while c is not None:
        chain.append(c)
        c = getattr(c, "BASE", None)
    return list(reversed(chain))


def _init_defaults(obj: Any, cls: type) -> None:
    init = getattr(cls, "init_defaults", None)
    if init:
        init(obj)


def dump_binary_file(path: str, obj: Any) -> None:
    out = bytearray()
    binary_serialize(obj, out)
    with open(path, "wb") as f:
        f.write(out)


def load_binary_file(path: str, cls: type) -> Any:
    with open(path, "rb") as f:
        return binary_deserialize(cls, Reader(f.read()))
