"""Block-compression codecs (BC1, BC6H-UF16) — the port's copy of the JAX
package's `resource/bc.py`.

The reference engine stores every texture blob block-compressed: LDR formats
as BC1, HDR formats (DXGI 1..18) as BC6H_UF16, compressing on save and
decompressing on load (`Engine/Source/Resource/TextureCompression.cpp:6-22,
52-64`; usage in `BasicStorage.cpp:161-188`). The GPU-side textures are
uploaded *uncompressed*, so the codec only lives on the asset path. All
functions work on tightly-packed mip blobs: BC data is ceil(w/4)*ceil(h/4)
blocks per mip.

Differences from the JAX package's module: the native C++ codec
(`native/bcodec.cpp` through `native_codec.py`) is called where the JAX
package prefers it — every decode and the BC6H encode at quality "fast" —
with no fallback on an import error and no availability probe: the library
is built or the call raises. The numpy codec stays beside it under
`*_reference` names (`bc1_decode_mip_reference`,
`bc6h_decode_mip_reference`, `bc6h_encode_mip_reference`), the plain
version the tests hold the native codec to; the arithmetic is unchanged.
"""

from __future__ import annotations

import numpy as np

from .formats import (
    ETextureFormat,
    calc_texture_size,
    is_bgra,
    is_hdr_format,
    pixel_size,
)

BC1_BYTES_PER_BLOCK = 8
BC6H_BYTES_PER_BLOCK = 16


def _blocks(dim: int) -> int:
    return max(1, (dim + 3) // 4)


def bc_compressed_size(width: int, height: int, mip_levels: int, bytes_per_block: int) -> int:
    total = 0
    for i in range(mip_levels):
        mw, mh = max(1, width >> i), max(1, height >> i)
        total += _blocks(mw) * _blocks(mh) * bytes_per_block
    return total


# ---------------------------------------------------------------------------
# BC1
# ---------------------------------------------------------------------------

def _rgb565_to_rgb888(c: np.ndarray) -> np.ndarray:
    """(N,) uint16 -> (N, 3) uint8, D3D bit-replication rounding."""
    r = ((c >> 11) & 0x1F).astype(np.uint16)
    g = ((c >> 5) & 0x3F).astype(np.uint16)
    b = (c & 0x1F).astype(np.uint16)
    r = (r << 3) | (r >> 2)
    g = (g << 2) | (g >> 4)
    b = (b << 3) | (b >> 2)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def bc1_decode_mip(data: bytes | np.ndarray, width: int, height: int) -> np.ndarray:
    """Decode one BC1 mip -> (height, width, 4) uint8 RGBA (native codec)."""
    from . import native_codec

    return native_codec.bc1_decode_mip(data, width, height)


def bc1_decode_mip_reference(data: bytes | np.ndarray, width: int, height: int) -> np.ndarray:
    """`bc1_decode_mip`'s numpy version."""
    bw, bh = _blocks(width), _blocks(height)
    raw = np.frombuffer(memoryview(data), dtype=np.uint8, count=bw * bh * 8).reshape(bh, bw, 8)
    c0 = raw[..., 0].astype(np.uint16) | (raw[..., 1].astype(np.uint16) << 8)
    c1 = raw[..., 2].astype(np.uint16) | (raw[..., 3].astype(np.uint16) << 8)
    idx_bytes = raw[..., 4:8]  # (bh, bw, 4) one byte per block row

    p0 = _rgb565_to_rgb888(c0.ravel()).astype(np.int32).reshape(bh, bw, 3)
    p1 = _rgb565_to_rgb888(c1.ravel()).astype(np.int32).reshape(bh, bw, 3)
    opaque = (c0 > c1)[..., None]
    p2 = np.where(opaque, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(opaque, (p0 + 2 * p1) // 3, 0)

    palette = np.stack([p0, p1, p2, p3], axis=2).astype(np.uint8)  # (bh, bw, 4, 3)
    alpha = np.stack(
        [
            np.full((bh, bw), 255, np.uint8),
            np.full((bh, bw), 255, np.uint8),
            np.full((bh, bw), 255, np.uint8),
            np.where(c0 > c1, 255, 0).astype(np.uint8),
        ],
        axis=2,
    )  # (bh, bw, 4)

    # Per-texel 2-bit indices: texel (ty, tx) -> bits (2*tx..2*tx+1) of byte ty.
    shifts = np.arange(4, dtype=np.uint8) * 2
    sel = (idx_bytes[..., :, None] >> shifts[None, None, None, :]) & 0x3  # (bh,bw,4,4)

    bi = np.arange(bh * bw)
    sel_flat = sel.reshape(bh * bw, 16)
    rgb = palette.reshape(bh * bw, 4, 3)[bi[:, None], sel_flat]  # (N,16,3)
    a = alpha.reshape(bh * bw, 4)[bi[:, None], sel_flat]  # (N,16)
    texels = np.concatenate([rgb, a[..., None]], axis=-1).reshape(bh, bw, 4, 4, 4)

    img = texels.transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 4)
    return np.ascontiguousarray(img[:height, :width])


def bc1_encode_mip(rgba: np.ndarray) -> bytes:
    """Encode (h, w, 4) uint8 -> BC1 blob (opaque; principal-axis endpoints)."""
    h, w = rgba.shape[:2]
    bw, bh = _blocks(w), _blocks(h)
    # Pad to block grid by edge replication.
    pad = np.pad(rgba[..., :3], ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)), mode="edge")
    blocks = (
        pad.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(bh * bw, 16, 3)
    ).astype(np.float32)

    # Endpoints: min/max projections along the principal direction (max-min).
    cmin = blocks.min(axis=1)
    cmax = blocks.max(axis=1)
    axis = cmax - cmin
    axis_len = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = np.where(axis_len > 1e-6, axis / np.maximum(axis_len, 1e-6), 0.0)
    proj = np.einsum("ntc,nc->nt", blocks - cmin[:, None, :], axis)
    lo_i = proj.argmin(axis=1)
    hi_i = proj.argmax(axis=1)
    n = np.arange(blocks.shape[0])
    e0 = blocks[n, hi_i]  # max endpoint first => opaque mode (c0 > c1)
    e1 = blocks[n, lo_i]

    def to565(c):
        r = (np.round(c[:, 0] / 255.0 * 31).astype(np.uint16)) << 11
        g = (np.round(c[:, 1] / 255.0 * 63).astype(np.uint16)) << 5
        b = np.round(c[:, 2] / 255.0 * 31).astype(np.uint16)
        return r | g | b

    c0 = to565(e0)
    c1 = to565(e1)
    # Ensure c0 > c1 for the 4-color mode; swap if needed.
    swap = c0 < c1
    c0s, c1s = np.where(swap, c1, c0), np.where(swap, c0, c1)
    eq = c0s == c1s

    p0 = _rgb565_to_rgb888(c0s).astype(np.float32)
    p1 = _rgb565_to_rgb888(c1s).astype(np.float32)
    palette = np.stack([p0, p1, (2 * p0 + p1) / 3, (p0 + 2 * p1) / 3], axis=1)

    d = blocks[:, :, None, :] - palette[:, None, :, :]
    best = np.einsum("ntpc,ntpc->ntp", d, d).argmin(axis=-1).astype(np.uint8)
    best = np.where(eq[:, None], 0, best)

    shifts = (np.arange(16, dtype=np.uint32) % 4) * 2
    bits = (best.astype(np.uint32) << shifts[None, :]).reshape(-1, 4, 4).sum(axis=2)

    out = np.zeros((blocks.shape[0], 8), dtype=np.uint8)
    out[:, 0] = c0s & 0xFF
    out[:, 1] = c0s >> 8
    out[:, 2] = c1s & 0xFF
    out[:, 3] = c1s >> 8
    out[:, 4:8] = bits.astype(np.uint8)
    return out.tobytes()


# ---------------------------------------------------------------------------
# BC6H (UF16) — decode all 14 modes; encode uses mode 11 only.
# Spec: https://learn.microsoft.com/windows/win32/direct3d11/bc6h-format
# ---------------------------------------------------------------------------

# Partition table for 2-region blocks (standard BPTC P2 table, 32 partitions x 16 texels).
_P2 = np.array([
    [0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1],[0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1],
    [0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1],[0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1],[0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1],
    [0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1],[0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1],
    [0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1],
    [0,0,0,0,1,0,0,0,1,1,1,0,1,1,1,1],[0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0],[0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0],
    [0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0],[0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0],
    [0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0],[0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1],
    [0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0],[0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0],
    [0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0],[0,0,1,1,0,1,1,0,0,1,1,0,1,1,0,0],
    [0,0,0,1,0,1,1,1,1,1,1,0,1,0,0,0],[0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0],
    [0,1,1,1,0,0,0,1,1,0,0,0,1,1,1,0],[0,0,1,1,1,0,0,1,1,0,0,1,1,1,0,0],
], dtype=np.int32)

# Anchor index of subset 1 for each partition (fix-up index, weight MSB = 0).
_P2_ANCHOR = np.array([
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15, 2, 8, 2, 2, 8, 8,15, 2, 8, 2, 2, 8, 8, 2, 2,
], dtype=np.int32)

_W3 = np.array([0, 9, 18, 27, 37, 46, 55, 64], dtype=np.int32)
_W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], dtype=np.int32)


class _BitReader:
    def __init__(self, block: np.ndarray):
        self.bits = np.unpackbits(block, bitorder="little")
        self.pos = 0

    def read(self, n: int) -> int:
        v = 0
        for i in range(n):
            v |= int(self.bits[self.pos + i]) << i
        self.pos += n
        return v

    def read_rev(self, n: int) -> int:
        """Read n bits that are stored MSB-first (used by some mode fields)."""
        v = 0
        for i in range(n):
            v = (v << 1) | int(self.bits[self.pos + i])
        self.pos += n
        return v


# Mode table: mode bits -> (endpoint precision, delta bits (r,g,b), transformed, regions)
_BC6H_MODES = {
    0x00: (10, (5, 5, 5), True, 2),
    0x01: (7, (6, 6, 6), True, 2),
    0x02: (11, (5, 4, 4), True, 2),
    0x06: (11, (4, 5, 4), True, 2),
    0x0A: (11, (4, 4, 5), True, 2),
    0x0E: (9, (5, 5, 5), True, 2),
    0x12: (8, (6, 5, 5), True, 2),
    0x16: (8, (5, 6, 5), True, 2),
    0x1A: (8, (5, 5, 6), True, 2),
    0x1E: (6, (6, 6, 6), False, 2),
    0x03: (10, (10, 10, 10), False, 1),
    0x07: (11, (9, 9, 9), True, 1),
    0x0B: (12, (8, 8, 8), True, 1),
    0x0F: (16, (4, 4, 4), True, 1),
}

# Endpoint bit layouts per the D3D11 functional spec ("BC6H Format" table):
# space-separated fields in STORAGE order; `rw0-9` = bits 0..9 of endpoint w's
# red channel stored LSB-first, `rw15-10` (descending) = stored MSB-first,
# `gy4` = the single bit 4. Endpoints w/x = region-0 low/high, y/z = region-1
# low/high; the partition field d[4:0] follows (2-region modes only).
_BC6H_LAYOUTS = {
    0x00: "gy4 by4 bz4 rw0-9 gw0-9 bw0-9 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 "
          "bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    0x01: "gy5 gz4 gz5 rw0-6 bz0 bz1 by4 gw0-6 by5 bz2 gy4 bw0-6 bz3 bz5 "
          "bz4 rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5",
    0x02: "rw0-9 gw0-9 bw0-9 rx0-4 rw10 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-3 "
          "bw10 bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    0x06: "rw0-9 gw0-9 bw0-9 rx0-3 rw10 gz4 gy0-3 gx0-4 gw10 gz0-3 bx0-3 "
          "bw10 bz1 by0-3 ry0-3 bz0 bz2 rz0-3 gy4 bz3",
    0x0A: "rw0-9 gw0-9 bw0-9 rx0-3 rw10 by4 gy0-3 gx0-3 gw10 bz0 gz0-3 "
          "bx0-4 bw10 by0-3 ry0-3 bz1 bz2 rz0-3 bz4 bz3",
    0x0E: "rw0-8 by4 gw0-8 gy4 bw0-8 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 "
          "bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    0x12: "rw0-7 gz4 by4 gw0-7 bz2 gy4 bw0-7 bz3 bz4 rx0-5 gy0-3 gx0-4 bz0 "
          "gz0-3 bx0-4 bz1 by0-3 ry0-5 rz0-5",
    0x16: "rw0-7 bz0 by4 gw0-7 gy5 gy4 bw0-7 gz5 bz4 rx0-4 gz4 gy0-3 "
          "gx0-5 gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    0x1A: "rw0-7 bz1 by4 gw0-7 by5 gy4 bw0-7 bz5 bz4 rx0-4 gz4 gy0-3 "
          "gx0-4 bz0 gz0-3 bx0-5 by0-3 ry0-4 bz2 rz0-4 bz3",
    0x1E: "rw0-5 gz4 bz0 bz1 by4 gw0-5 gy5 by5 bz2 gy4 bw0-5 gz5 bz3 bz5 "
          "bz4 rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5",
    0x03: "rw0-9 gw0-9 bw0-9 rx0-9 gx0-9 bx0-9",
    0x07: "rw0-9 gw0-9 bw0-9 rx0-8 rw10 gx0-8 gw10 bx0-8 bw10",
    0x0B: "rw0-9 gw0-9 bw0-9 rx0-7 rw11-10 gx0-7 gw11-10 bx0-7 bw11-10",
    0x0F: "rw0-9 gw0-9 bw0-9 rx0-3 rw15-10 gx0-3 gw15-10 bx0-3 bw15-10",
}

_EP_IDX = {"w": 0, "x": 1, "y": 2, "z": 3}
_CH_IDX = {"r": 0, "g": 1, "b": 2}


def _parse_layout(s: str):
    """-> list of (e_idx, ch, bit) in storage order."""
    out = []
    for tok in s.split():
        ch, e = _CH_IDX[tok[0]], _EP_IDX[tok[1]]
        span = tok[2:]
        if "-" in span:
            a, b = (int(x) for x in span.split("-"))
            bits = range(a, b + 1) if a <= b else range(a, b - 1, -1)
        else:
            bits = (int(span),)
        out.extend((e, ch, bit) for bit in bits)
    return out


_BC6H_FIELDS = {m: _parse_layout(s) for m, s in _BC6H_LAYOUTS.items()}


def _unquantize_unsigned(x: int, prec: int) -> int:
    if prec >= 15:
        return x
    if x == 0:
        return 0
    if x == (1 << prec) - 1:
        return 0xFFFF
    return ((x << 16) + 0x8000) >> prec


def _finalize_unsigned(x: int) -> int:
    return (x * 31) >> 6


def _decode_bc6h_block(block: np.ndarray) -> np.ndarray:
    """Decode one 16-byte BC6H UF16 block -> (4, 4, 3) float32 texels.

    Bit layouts follow the D3D11 functional spec; this implementation favors
    clarity over speed (the C++ codec in native/ is the fast path).
    """
    br = _BitReader(block)
    m = br.read(2)
    if m >= 2:
        m = (br.read(3) << 2) | m
    if m not in _BC6H_MODES:
        return np.zeros((4, 4, 3), dtype=np.float32)
    prec, (dr, dg, db), transformed, regions = _BC6H_MODES[m]

    # Endpoints as bit fields e[region*2 + (0=low,1=high)][channel]
    ep = [[0, 0, 0] for _ in range(4)]
    for e_idx, ch, bit in _BC6H_FIELDS[m]:
        ep[e_idx][ch] |= br.read(1) << bit

    partition = br.read(5) if regions == 2 else 0

    # Apply delta transform.
    mask = (1 << prec) - 1
    if transformed:
        deltas = (dr, dg, db)
        for e_idx in range(1, regions * 2):
            for ch in range(3):
                dbits = deltas[ch]
                d = ep[e_idx][ch]
                # sign-extend delta
                if d >= (1 << (dbits - 1)):
                    d -= 1 << dbits
                ep[e_idx][ch] = (ep[0][ch] + d) & mask

    # Unquantize, interpolate.
    nsub = regions
    weights = _W3 if nsub == 2 else _W4
    ibits = 3 if nsub == 2 else 4

    uq = [[_unquantize_unsigned(ep[e][c], prec) for c in range(3)] for e in range(nsub * 2)]

    if nsub == 2:
        part_row = _P2[partition]
        anchor2 = _P2_ANCHOR[partition]
    else:
        part_row = np.zeros(16, dtype=np.int32)
        anchor2 = -1

    out = np.zeros((16, 3), dtype=np.uint16)
    for t in range(16):
        subset = int(part_row[t])
        nb = ibits - 1 if (t == 0 or t == anchor2) else ibits
        w = weights[br.read(nb)]
        for c in range(3):
            a = uq[subset * 2][c]
            b = uq[subset * 2 + 1][c]
            v = (a * (64 - w) + b * w + 32) >> 6
            out[t, c] = _finalize_unsigned(v)

    half = out.view(np.float16).astype(np.float32)
    return half.reshape(4, 4, 3)


def bc6h_decode_mip(data: bytes | np.ndarray, width: int, height: int) -> np.ndarray:
    """Decode one BC6H UF16 mip -> (height, width, 4) float16 RGBA (A=1)
    (native codec)."""
    from . import native_codec

    return native_codec.bc6h_decode_mip(data, width, height)


def bc6h_decode_mip_reference(data: bytes | np.ndarray, width: int,
                              height: int) -> np.ndarray:
    """`bc6h_decode_mip`'s numpy version."""
    bw, bh = _blocks(width), _blocks(height)
    raw = np.frombuffer(memoryview(data), dtype=np.uint8, count=bw * bh * 16).reshape(-1, 16)
    texels = np.zeros((bh * bw, 4, 4, 3), dtype=np.float32)
    for i in range(raw.shape[0]):
        texels[i] = _decode_bc6h_block(raw[i])
    img = texels.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 3)
    img = img[:height, :width]
    rgba = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    return rgba.astype(np.float16)


def _quantize_mode11(x: np.ndarray) -> np.ndarray:
    """f16 bits (unsigned range) -> 10-bit mode-11 endpoint.

    Inverts the decode chain: final_bits = (unquantize(e) * 31) >> 6 with
    unquantize(e) ~= e*64 + 32, so e ~= bits/31 - 0.5."""
    # floor(x/31) == round-half-away(x/31 - 0.5) for x >= 0 — matches the
    # C++ codec's lround; np.round's half-even ties would collapse near-flat
    # blocks' endpoints (e.g. bits 14291: 461 here, 460 under half-even)
    e = np.floor(x.astype(np.float64) / 31.0)
    return np.clip(e, 0, 1023).astype(np.int32)


def _unq10(e):
    """Vectorized _unquantize_unsigned for 10-bit endpoints."""
    x = np.asarray(e, np.int64)
    out = ((x << 16) + 0x8000) >> 10
    out = np.where(x == 0, 0, out)
    out = np.where(x == 1023, 0xFFFF, out)
    return out


def _mode11_candidate(blocks: np.ndarray, bits16: np.ndarray):
    """Mode-11 (single region, 10-bit endpoints, 4-bit indices) encode of
    every block. Returns (e0, e1, idx, err) with err = decoded squared error
    in float space (the selection metric for the quality path)."""
    cmin = bits16.min(axis=1)
    cmax = bits16.max(axis=1)
    e0 = _quantize_mode11(cmin)
    e1 = _quantize_mode11(cmax)

    u0, u1 = _unq10(e0), _unq10(e1)  # (N,3)
    w4 = _W4.astype(np.int64)
    pal = ((u0[:, None, :] * (64 - w4[None, :, None]) + u1[:, None, :] * w4[None, :, None] + 32) >> 6)
    pal = (pal * 31) >> 6  # (N,16,3) f16 bit patterns
    palf = pal.astype(np.uint16).view(np.float16).astype(np.float32)
    blockf = blocks.astype(np.float32)
    d = blockf[:, :, None, :] - palf[:, None, :, :]
    dist = np.einsum("ntpc,ntpc->ntp", d, d)  # (N,16,16)
    idx = dist.argmin(axis=-1).astype(np.int64)  # (N,16)
    # Anchor texel 0 has only 3 index bits (MSB implicitly 0): restrict its
    # argmin to the first 8 palette entries.
    idx[:, 0] = dist[:, 0, :8].argmin(axis=-1)
    err = np.take_along_axis(dist, idx[..., None], axis=-1)[..., 0].sum(axis=1)
    return e0, e1, idx, err


def _quantize_prec(bits: np.ndarray, prec: int) -> np.ndarray:
    """f16 bit patterns (unsigned range) -> prec-bit endpoint.

    Inverts the full decode chain final = (unquantize(e) * 31) >> 6 with
    unquantize(e) ~= e * 2^16 / 2^prec, so e ~= bits * 2^prec / (31*1024)
    - 0.5 rounded half-away == floor(bits * 2^prec / 31744) (the prec=10
    case reduces to _quantize_mode11)."""
    e = np.floor(bits.astype(np.float64) * (1 << prec) / 31744.0)
    return np.clip(e, 0, (1 << prec) - 1).astype(np.int64)


def _unq_prec(e, prec: int):
    """Vectorized _unquantize_unsigned."""
    x = np.asarray(e, np.int64)
    out = ((x << 16) + 0x8000) >> prec
    out = np.where(x == 0, 0, out)
    out = np.where(x == (1 << prec) - 1, 0xFFFF, out)
    return out


def _mode2_candidates(blocks: np.ndarray, bits16: np.ndarray, mode: int):
    """Two-region candidates for `mode` over ALL 32 partitions, vectorized
    over blocks.

    Returns (ep_store (N,32,4,3) field values [w raw prec-bit, x/y/z as
    dbits-bit two's-complement deltas — or raw endpoints for untransformed
    modes], idx (N,32,16) 3-bit indices obeying both anchor MSB constraints,
    err (N,32)). Every candidate is decode-valid: deltas are clamped to the
    representable range and the error is measured against the
    exactly-reconstructed palette."""
    prec, dbits, transformed, regions = _BC6H_MODES[mode]
    assert regions == 2
    n = blocks.shape[0]
    blockf = blocks.astype(np.float32)
    w3 = _W3.astype(np.int64)
    big = np.int64(1) << 40
    mask = (1 << prec) - 1

    ep_store = np.zeros((n, 32, 4, 3), np.int64)
    idx_all = np.zeros((n, 32, 16), np.int64)
    err_all = np.zeros((n, 32), np.float64)

    for p in range(32):
        part = _P2[p]                       # (16,) 0/1 subset per texel
        anchor2 = int(_P2_ANCHOR[p])
        in1 = part.astype(bool)[None, :, None]       # (1,16,1)
        lo0 = np.where(in1, big, bits16).min(axis=1)
        hi0 = np.where(in1, -1, bits16).max(axis=1)
        lo1 = np.where(in1, bits16, big).min(axis=1)
        hi1 = np.where(in1, bits16, -1).max(axis=1)
        eq = np.stack([_quantize_prec(lo0, prec), _quantize_prec(hi0, prec),
                       _quantize_prec(lo1, prec), _quantize_prec(hi1, prec)],
                      axis=1)                        # (N,4,3) w,x,y,z

        # provisional palette/indices to decide endpoint swaps so the two
        # anchor texels (index MSB stored as 0) land in the low half
        def palette(e):                              # (N,4,3) -> (N,2,8,3) f32
            uq = _unq_prec(e, prec)
            lo = uq[:, 0::2, None, :]
            hi = uq[:, 1::2, None, :]
            pal = ((lo * (64 - w3[None, None, :, None])
                    + hi * w3[None, None, :, None] + 32) >> 6)
            pal = (pal * 31) >> 6
            return pal.astype(np.uint16).view(np.float16).astype(np.float32)

        def best_idx(palf):                          # -> idx (N,16), dist
            pal_t = palf[:, part, :, :]              # (N,16,8,3)
            d = blockf[:, :, None, :] - pal_t
            dist = np.einsum("ntpc,ntpc->ntp", d, d)  # (N,16,8)
            idx = dist.argmin(axis=-1).astype(np.int64)
            # anchor texels store ibits-1 bits -> index must be < 4
            for a in (0, anchor2):
                idx[:, a] = dist[:, a, :4].argmin(axis=-1)
            return idx, dist

        idx0, _ = best_idx(palette(eq))
        swap_s0 = idx0[:, 0] >= 4
        swap_s1 = idx0[:, anchor2] >= 4
        eqs = eq.copy()
        eqs[swap_s0, 0], eqs[swap_s0, 1] = eq[swap_s0, 1], eq[swap_s0, 0]
        eqs[swap_s1, 2], eqs[swap_s1, 3] = eq[swap_s1, 3], eq[swap_s1, 2]

        if transformed:
            # delta vs base w, clamped to signed dbits; reconstruct the
            # endpoints the DECODER will see and rebuild the exact palette
            half = [1 << (b - 1) for b in dbits]
            d = np.stack([
                np.clip(eqs[:, 1:, c] - eqs[:, :1, c],
                        -half[c], half[c] - 1) for c in range(3)], axis=-1)
            recon = np.concatenate(
                [eqs[:, :1, :], (eqs[:, :1, :] + d) & mask], axis=1)
            store = np.concatenate(
                [eqs[:, :1, :],
                 d & np.array([(1 << b) - 1 for b in dbits])[None, None, :]],
                axis=1)
        else:
            recon = eqs
            store = eqs
        idx, dist = best_idx(palette(recon))
        err = np.take_along_axis(dist, idx[..., None], axis=-1)[..., 0].sum(1)

        ep_store[:, p] = store
        idx_all[:, p] = idx
        err_all[:, p] = err
    return ep_store, idx_all, err_all


def _pack_block_fields(mode: int, ep, partition: int, idx, ibits: int,
                       anchor2: int) -> bytes:
    """Pack one block through the decoder's own field table
    (_BC6H_FIELDS[mode]) — layout consistency with decode by construction."""
    bitbuf = 0
    pos = 0

    def put(v, nb):
        nonlocal bitbuf, pos
        bitbuf |= (int(v) & ((1 << nb) - 1)) << pos
        pos += nb

    if mode < 2:
        put(mode, 2)
    else:
        put(mode & 3, 2)
        put(mode >> 2, 3)
    for e_idx, ch, bit in _BC6H_FIELDS[mode]:
        put((int(ep[e_idx][ch]) >> bit) & 1, 1)
    if _BC6H_MODES[mode][3] == 2:
        put(partition, 5)
    for t in range(16):
        nb = ibits - 1 if (t == 0 or t == anchor2) else ibits
        put(idx[t], nb)
    return bitbuf.to_bytes(16, "little")


# Module-level default for the asset save path (compress_texture /
# TextureData.compress_payload); the import console's --hdr-quality flag
# flips it to "high" for DirectXTex-grade multi-mode search.
BC6H_QUALITY_DEFAULT = "fast"


def bc6h_encode_mip(rgba_f16: np.ndarray, quality: str | None = None) -> bytes:
    """Encode (h, w, >=3) float16 -> BC6H UF16.

    quality="fast": mode 11 only (single region, 10-bit endpoints, 4-bit
    indices) — the C++ codec fast path (native/bcodec.cpp).
    quality="high": per block, mode 11 competes against two-region
    candidates (mode 0: 10-bit base + 5-bit deltas for gentle blocks;
    mode 1: 7-bit + 6-bit deltas; mode 30: 6-bit untransformed for blocks
    whose subsets sit far apart) across all 32 BPTC partitions; the
    candidate with the smallest decoded squared error wins — the role of
    DirectXTex's multi-mode search (TextureCompression.cpp:24-50) for the
    asset save path.

    The native codec runs the "fast" quality, the numpy version
    (`bc6h_encode_mip_reference`) the "high" one."""
    if quality is None:
        quality = BC6H_QUALITY_DEFAULT
    if quality == "fast":
        from . import native_codec

        return native_codec.bc6h_encode_mip(rgba_f16)
    return bc6h_encode_mip_reference(rgba_f16, quality)


def bc6h_encode_mip_reference(rgba_f16: np.ndarray, quality: str | None = None) -> bytes:
    """`bc6h_encode_mip`'s numpy version, at either quality."""
    if quality is None:
        quality = BC6H_QUALITY_DEFAULT
    h, w = rgba_f16.shape[:2]
    bw, bh = _blocks(w), _blocks(h)
    rgb = np.asarray(rgba_f16[..., :3], dtype=np.float16)
    rgb = np.maximum(rgb, np.float16(0))  # UF16: unsigned
    pad = np.pad(rgb, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)), mode="edge")
    blocks = pad.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    bits16 = blocks.view(np.uint16).astype(np.int64)  # monotonic for non-negative halfs

    e0, e1, idx11, err11 = _mode11_candidate(blocks, bits16)
    n_blocks = blocks.shape[0]

    best_mode = np.full(n_blocks, 0x03, np.int64)     # mode 11 default
    best_part = np.zeros(n_blocks, np.int64)
    best_err = err11.astype(np.float64)
    cand = {}
    if quality == "high":
        for m in (0x00, 0x01, 0x1E):
            ep_m, idx_m, err_m = _mode2_candidates(blocks, bits16, m)
            cand[m] = (ep_m, idx_m)
            p_m = err_m.argmin(axis=1)
            e_m = np.take_along_axis(err_m, p_m[:, None], axis=1)[:, 0]
            win = e_m < best_err
            best_mode = np.where(win, m, best_mode)
            best_part = np.where(win, p_m, best_part)
            best_err = np.where(win, e_m, best_err)

    out = bytearray()
    for i in range(n_blocks):
        m = int(best_mode[i])
        if m == 0x03:
            ep = np.stack([e0[i], e1[i], np.zeros(3, np.int64),
                           np.zeros(3, np.int64)])
            out += _pack_block_fields(0x03, ep, 0, idx11[i], 4, -1)
        else:
            p = int(best_part[i])
            ep_m, idx_m = cand[m]
            out += _pack_block_fields(m, ep_m[i, p], p, idx_m[i, p], 3,
                                      int(_P2_ANCHOR[p]))
    return bytes(out)


# ---------------------------------------------------------------------------
# Whole-blob (mip chain) compress/decompress — TextureCompressor equivalent.
# ---------------------------------------------------------------------------

def compress_texture(
    width: int, height: int, mip_levels: int, fmt: ETextureFormat, data: bytes
) -> bytes:
    """TextureCompressor::Compress: raw mip chain -> BC mip chain."""
    fmt = ETextureFormat(fmt)
    psize = pixel_size(fmt)
    out = bytearray()
    offset = 0
    hdr = is_hdr_format(fmt)
    for i in range(mip_levels):
        mw, mh = max(1, width >> i), max(1, height >> i)
        n = mw * mh * psize
        mip = np.frombuffer(data[offset : offset + n], dtype=np.uint8)
        offset += n
        if hdr:
            if fmt == ETextureFormat.R32G32B32A32_FLOAT:
                px = mip.view(np.float32).reshape(mh, mw, 4).astype(np.float16)
            elif fmt == ETextureFormat.R16G16B16A16_FLOAT:
                px = mip.view(np.float16).reshape(mh, mw, 4)
            else:
                raise NotImplementedError(f"BC6H compress for {fmt}")
            out += bc6h_encode_mip(px)
        else:
            if fmt in (ETextureFormat.R8G8B8A8_UNORM, ETextureFormat.R8G8B8A8_UNORM_SRGB):
                rgba = mip.reshape(mh, mw, 4)
            elif is_bgra(fmt):
                rgba = mip.reshape(mh, mw, 4)[..., [2, 1, 0, 3]]
            elif fmt == ETextureFormat.R8_UNORM:
                r = mip.reshape(mh, mw, 1)
                rgba = np.concatenate([r, r, r, np.full_like(r, 255)], axis=-1)
            else:
                raise NotImplementedError(f"BC1 compress for {fmt}")
            out += bc1_encode_mip(np.ascontiguousarray(rgba))
    return bytes(out)


def decompress_texture(
    width: int, height: int, mip_levels: int, fmt: ETextureFormat, data: bytes
) -> bytes:
    """TextureCompressor::Decompress: BC mip chain -> raw mip chain (bytes),
    layout identical to CalculateTextureSize/CalculateMipmapLayout."""
    fmt = ETextureFormat(fmt)
    psize = pixel_size(fmt)
    hdr = is_hdr_format(fmt)
    bpb = BC6H_BYTES_PER_BLOCK if hdr else BC1_BYTES_PER_BLOCK
    out = bytearray(calc_texture_size(width, height, mip_levels, psize))
    src = 0
    dst = 0
    for i in range(mip_levels):
        mw, mh = max(1, width >> i), max(1, height >> i)
        nblocks = _blocks(mw) * _blocks(mh)
        comp = data[src : src + nblocks * bpb]
        src += nblocks * bpb
        if hdr:
            rgba = bc6h_decode_mip(comp, mw, mh)  # f16
            if fmt == ETextureFormat.R32G32B32A32_FLOAT:
                raw = rgba.astype(np.float32).tobytes()
            elif fmt == ETextureFormat.R16G16B16A16_FLOAT:
                raw = rgba.tobytes()
            else:
                raise NotImplementedError(f"BC6H decompress to {fmt}")
        else:
            rgba = bc1_decode_mip(comp, mw, mh)
            if fmt in (ETextureFormat.R8G8B8A8_UNORM, ETextureFormat.R8G8B8A8_UNORM_SRGB):
                raw = rgba.tobytes()
            elif is_bgra(fmt):
                raw = np.ascontiguousarray(rgba[..., [2, 1, 0, 3]]).tobytes()
            elif fmt == ETextureFormat.R8_UNORM:
                raw = np.ascontiguousarray(rgba[..., 0]).tobytes()
            elif fmt == ETextureFormat.R8G8_UNORM:
                raw = np.ascontiguousarray(rgba[..., :2]).tobytes()
            else:
                raise NotImplementedError(f"BC1 decompress to {fmt}")
        n = mw * mh * psize
        out[dst : dst + n] = raw
        dst += n
    return bytes(out)
