"""Bloom — counterpart of `ops/bloom.py` (the matrix blur-resize pyramid).

Threshold prefilter + separable-Gaussian mip pyramid + merge in the
reference's pass order (BloomPass::Execute, DeferredPipeline.cpp:400-570).
Every down/up/merge step after the nonlinear prefilter is `blur_v ∘ blur_h ∘
resize`, linear along each axis, so it folds into one precomputed matrix per
axis and runs as `torch.matmul`. The products are float32 (callers keep
`torch.backends.cuda.matmul.allow_tf32` off, its default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import BLOOM_KNEE, BLOOM_STEPS, BLOOM_THRESHOLD, GAUSS_WEIGHTS

from . import common

_R = 4


def _shift(img, dy, dx, lo=0, hi=None):
    """Clamp-to-edge shifted view (the LinearClamp sampling analog) of rows
    [lo, hi) (all rows by default)."""
    h, w = img.shape[0], img.shape[1]
    hi = h if hi is None else hi
    ys = torch.clamp(torch.arange(lo, hi, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


@functools.lru_cache(maxsize=None)
def _resize_matrix(out_n: int, in_n: int, half_phase: bool) -> np.ndarray:
    """(out_n, in_n) bilinear interpolation matrix with clamp addressing
    (half_phase: texel-center positions; else the prefilter's uv = xy*texel)."""
    o = np.arange(out_n, dtype=np.float64)
    pos = ((o + 0.5) if half_phase else o) * (in_n / out_n) - 0.5
    i0 = np.floor(pos)
    frac = pos - i0
    m = np.zeros((out_n, in_n), np.float32)
    lo = np.clip(i0.astype(np.int64), 0, in_n - 1)
    hi = np.clip(i0.astype(np.int64) + 1, 0, in_n - 1)
    m[o.astype(np.int64), lo] += (1.0 - frac).astype(np.float32)
    m[o.astype(np.int64), hi] += frac.astype(np.float32)
    return m


@functools.lru_cache(maxsize=None)
def _blur_mat(n: int) -> np.ndarray:
    """(n, n) float64 matrix of the 9-tap clamp-addressed Gaussian."""
    m = np.zeros((n, n), np.float64)
    w = np.asarray(GAUSS_WEIGHTS, np.float64)
    rows = np.arange(n)
    for t in range(-_R, _R + 1):
        np.add.at(m, (rows, np.clip(rows + t, 0, n - 1)), w[t + _R])
    return m


@functools.lru_cache(maxsize=None)
def _blur_resize_mat(out_n: int, in_n: int) -> np.ndarray:
    """(out_n, in_n) f32: blur ∘ bilinear-resize folded into one matrix."""
    return (_blur_mat(out_n) @ _resize_matrix(out_n, in_n, True).astype(np.float64)
            ).astype(np.float32)


def _t(m, like):
    return torch.as_tensor(m, dtype=torch.float32, device=like.device)


def _mm_rows(m, img):
    """einsum('oi,iwc->owc')."""
    h, w, c = img.shape
    return torch.matmul(_t(m, img), img.reshape(h, w * c)).reshape(-1, w, c)


def _mm_cols(m, img):
    """einsum('oi,hic->hoc')."""
    return torch.matmul(_t(m, img), img)


def resize_bilinear(img, out_h: int, out_w: int, half_phase: bool = True):
    """LinearClamp bilinear resize via interpolation-matrix matmuls."""
    in_h, in_w = img.shape[0], img.shape[1]
    out = img
    if out_h != in_h:
        out = _mm_rows(_resize_matrix(out_h, in_h, half_phase), out)
    if out_w != in_w:
        out = _mm_cols(_resize_matrix(out_w, in_w, half_phase), out)
    return out


def bloom_threshold(color, threshold=BLOOM_THRESHOLD, knee=BLOOM_KNEE):
    """Soft-knee bright-pass (bloom_prefilter.hlsl:16-26)."""
    brightness = color.amax(dim=-1, keepdim=True)
    soft = torch.clamp(brightness - threshold + threshold * knee, 0.0, 2 * threshold * knee)
    soft = soft * soft / (4 * threshold * knee + 1e-5)
    contribution = torch.maximum(soft, brightness - threshold) / torch.clamp(brightness,
                                                                              min=1e-5)
    return color * contribution


def prefilter(img, out_h: int, out_w: int):
    """bloom_prefilter at half resolution: 5-tap cross, luma-weighted to
    suppress fireflies (bloom_prefilter.hlsl:30-53)."""
    return _cross_filter(resize_bilinear(img, out_h, out_w, half_phase=False), 0, out_h)


def _cross_filter(base, lo: int, hi: int):
    """The prefilter's 5-tap cross on rows [lo, hi) of the whole half-res
    grid `base` (the taps read rows lo - 1 and hi, clamped to its edges)."""
    total = weight = 0.0
    for dy, dx in [(0, 0), (-1, -1), (-1, 1), (1, -1), (1, 1)]:
        c = bloom_threshold(_shift(base, dy, dx, lo, hi))
        wgt = 1.0 / (common.luminance(c)[..., None] + 1.0)
        total = total + c * wgt
        weight = weight + wgt
    return total / torch.clamp(weight, min=1e-20)


def bloom(hdr):
    """Full bloom chain; hdr (H, W, 3) -> (H, W, 3) with bloom added."""
    h, w = hdr.shape[0], hdr.shape[1]

    def mip_size(m):
        return max(1, h >> m), max(1, w >> m)

    a = {1: prefilter(hdr, *mip_size(1))}
    for i in range(BLOOM_STEPS):
        m = i + 1
        hh, ww = mip_size(m)
        lo_h, lo_w = mip_size(m + 1)
        a[m + 1] = _mm_cols(_blur_resize_mat(lo_w, ww),
                            _mm_rows(_blur_resize_mat(lo_h, hh), a[m]))
    for i in range(BLOOM_STEPS - 1, -1, -1):
        m = i + 1
        hh, ww = mip_size(m)
        lh, lw = mip_size(m + 1)
        bv = _blur_mat(hh).astype(np.float32)
        bh = _blur_mat(ww).astype(np.float32)
        a[m] = (_mm_cols(bh, _mm_rows(bv, a[m]))
                + _mm_cols(_blur_resize_mat(ww, lw), _mm_rows(_blur_resize_mat(hh, lh), a[m + 1])))
    full = _mm_cols(_blur_resize_mat(w, mip_size(1)[1]),
                    _mm_rows(_blur_resize_mat(h, mip_size(1)[0]), a[1]))
    return hdr + full


def bloom_band(band, height: int, mesh):
    """`bloom`'s rows of one band: the frame's `height` rows split into
    `mesh.size` equal row bands, `band` (height // size, W, 3) being band
    `mesh.rank`. Returns the band's rows of bloom(hdr). `mesh` is the
    band group (`parallel/frame_sharded.BandMesh`): its `all_reduce` sums a
    tensor over the ranks and its `gather` builds a whole level from each
    rank's rows (every rank calls them in the same order).

    A pyramid level is row-parallel when each rank keeps at least 16 of its
    rows (the JAX package's row-sharding rule, `ops/bloom.py`): a rank then
    multiplies only its rows of the level's row matrix by the whole
    previous level, which it gathers as a sum of zero-filled levels holding
    each rank's rows (exact). Smaller levels are computed whole on every
    rank. The prefilter's half-resolution grid is the sum of each band's
    share of the row resize; the cross filter then reads its rows' +-1
    neighbours from the whole grid."""
    band_h, w = band.shape[0], band.shape[1]
    rank, n = mesh.rank, mesh.size
    y0 = rank * band_h

    def mip_size(m):
        return max(1, height >> m), max(1, w >> m)

    def rows_of(n_rows):
        if n_rows // n >= 16:
            return n_rows * rank // n, n_rows * (rank + 1) // n
        return 0, n_rows

    def whole(part, n_rows):
        lo, hi = rows_of(n_rows)
        return part if (lo, hi) == (0, n_rows) else mesh.gather(part, n_rows, lo)

    h1, w1 = mip_size(1)
    rows = _resize_matrix(h1, height, False)[:, y0:y0 + band_h]   # the band's columns
    base = mesh.all_reduce(_mm_cols(_resize_matrix(w1, w, False), _mm_rows(rows, band)))
    full = {1: whole(_cross_filter(base, *rows_of(h1)), h1)}
    for m in range(1, BLOOM_STEPS + 1):
        hh, ww = mip_size(m)
        lo_h, lo_w = mip_size(m + 1)
        r0, r1 = rows_of(lo_h)
        part = _mm_cols(_blur_resize_mat(lo_w, ww),
                        _mm_rows(_blur_resize_mat(lo_h, hh)[r0:r1], full[m]))
        full[m + 1] = whole(part, lo_h)
    for m in range(BLOOM_STEPS, 0, -1):
        hh, ww = mip_size(m)
        lh, lw = mip_size(m + 1)
        r0, r1 = rows_of(hh)
        bv = _blur_mat(hh).astype(np.float32)[r0:r1]
        bh = _blur_mat(ww).astype(np.float32)
        part = (_mm_cols(bh, _mm_rows(bv, full[m]))
                + _mm_cols(_blur_resize_mat(ww, lw),
                           _mm_rows(_blur_resize_mat(hh, lh)[r0:r1], full[m + 1])))
        full[m] = whole(part, hh)
    return band + _mm_cols(_blur_resize_mat(w, w1),
                           _mm_rows(_blur_resize_mat(height, h1)[y0:y0 + band_h], full[1]))
