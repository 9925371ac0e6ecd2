"""ctypes bindings for the native BC codecs (native/bcodec.cpp) — the port's
copy of the JAX package's `resource/native_codec.py`.

`bc.py` calls this module where the JAX package does (every decode, the
BC6H encode at quality "fast"). Differences: the port's `native.load()`
builds the library or raises, so there is no `available()` probe and no
numpy fallback behind it; the numpy codec stays in `bc.py` as the plain
version the tests hold this module to."""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def bc1_decode_mip(data, width: int, height: int) -> np.ndarray:
    lib = load()
    src = np.frombuffer(memoryview(data), dtype=np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    lib.bc1_decode(_ptr(src, ctypes.c_uint8), width, height, _ptr(out, ctypes.c_uint8))
    return out


def bc1_encode_mip(rgba: np.ndarray) -> bytes:
    lib = load()
    h, w = rgba.shape[:2]
    bw, bh = max(1, (w + 3) // 4), max(1, (h + 3) // 4)
    src = np.ascontiguousarray(rgba, np.uint8)
    out = np.empty(bw * bh * 8, np.uint8)
    lib.bc1_encode(_ptr(src, ctypes.c_uint8), w, h, _ptr(out, ctypes.c_uint8))
    return out.tobytes()


def bc6h_decode_mip(data, width: int, height: int) -> np.ndarray:
    lib = load()
    src = np.frombuffer(memoryview(data), dtype=np.uint8)
    out = np.empty((height, width, 4), np.uint16)
    lib.bc6h_decode(_ptr(src, ctypes.c_uint8), width, height, _ptr(out, ctypes.c_uint16))
    return out.view(np.float16)


def bc6h_encode_mip(rgba_f16: np.ndarray) -> bytes:
    lib = load()
    h, w = rgba_f16.shape[:2]
    bw, bh = max(1, (w + 3) // 4), max(1, (h + 3) // 4)
    if rgba_f16.shape[-1] == 3:
        rgba_f16 = np.concatenate(
            [rgba_f16, np.ones_like(rgba_f16[..., :1])], axis=-1
        )
    src = np.ascontiguousarray(rgba_f16, np.float16).view(np.uint16)
    out = np.empty(bw * bh * 16, np.uint8)
    lib.bc6h_encode(_ptr(src, ctypes.c_uint16), w, h, _ptr(out, ctypes.c_uint8))
    return out.tobytes()
