"""Radiance RGBE (.hdr) image IO — replacement for DirectXTex LoadFromHDRFile;
the port's copy of the JAX package's `resource/hdr.py`, unchanged.

Supports the common "-Y H +X W" orientation with both RLE-compressed and flat
scanlines; returns float32 RGB. Also provides `save_hdr` for round-trip tests
and asset authoring.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    f = rgbe.astype(np.float32)
    exp = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136)  # 2^(e-128-8)
    rgb = f[..., :3] * exp[..., None]
    rgb[rgbe[..., 3] == 0] = 0.0
    return rgb


def _encode_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8 RGBE."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), dtype=np.uint8)
    nz = maxc >= 1e-32
    _, exp = np.frexp(maxc[nz])
    scale = np.ldexp(1.0, -exp + 8)
    mant = np.clip(rgb[nz] * scale[..., None], 0, 255).astype(np.uint8)
    out[nz, :3] = mant
    out[nz, 3] = (exp + 128).astype(np.uint8)
    return out


def load_hdr(path: str | Path) -> np.ndarray:
    data = Path(path).read_bytes()
    # header
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].decode("ascii").split()
    pos = eol + 1
    if len(dims) != 4 or dims[0] != "-Y" or dims[2] != "+X":
        raise NotImplementedError(f"unsupported HDR orientation {dims}")
    height, width = int(dims[1]), int(dims[3])

    raw = np.frombuffer(data, dtype=np.uint8, offset=pos)
    img = np.zeros((height, width, 4), dtype=np.uint8)
    idx = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and idx + 4 <= raw.size
            and raw[idx] == 2
            and raw[idx + 1] == 2
            and ((int(raw[idx + 2]) << 8) | int(raw[idx + 3])) == width
        ):
            idx += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(raw[idx])
                    idx += 1
                    if count > 128:  # run
                        img[y, x : x + count - 128, c] = raw[idx]
                        idx += 1
                        x += count - 128
                    else:  # literal
                        img[y, x : x + count, c] = raw[idx : idx + count]
                        idx += count
                        x += count
        else:
            # flat scanline
            n = width * 4
            img[y] = raw[idx : idx + n].reshape(width, 4)
            idx += n
    return _decode_rgbe(img)


def save_hdr(path: str | Path, rgb: np.ndarray) -> None:
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    body = _encode_rgbe(rgb).reshape(h * w, 4).tobytes()
    Path(path).write_bytes(header + body)
