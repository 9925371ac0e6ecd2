"""HDR post — counterpart of `ops/postprocess.py`.

Luminance histogram (`hdr_luminance_histogram.hlsl`), the EMA-smoothed
average luminance (`hdr_average_histogram.hlsl`) and ACES tone mapping with
gamma 1/2.2 and RGBA8 quantization (`hdr_tone_mapping.hlsl`).
"""

from __future__ import annotations

import torch

from ..config import (
    EXPOSURE_SMOOTH_TIME,
    INV_LOG_LUMINANCE_RANGE,
    LOG_LUMINANCE_RANGE,
    MIN_LOG_LUMINANCE,
    NUM_HISTOGRAM_BINS,
)

from . import common


def luminance_histogram(hdr_rgb) -> torch.Tensor:
    """(H, W, 3) -> (256,) int64 counts."""
    return torch.bincount(luminance_bins(hdr_rgb).reshape(-1).long(),
                          minlength=NUM_HISTOGRAM_BINS)


def luminance_bins(hdr_rgb) -> torch.Tensor:
    """(H, W, 3) -> (H, W) int32 histogram bin indices."""
    lum = common.luminance(hdr_rgb)
    log_l = torch.clamp(
        (torch.log2(torch.clamp(lum, min=1e-30)) - MIN_LOG_LUMINANCE) * INV_LOG_LUMINANCE_RANGE,
        0.0, 1.0,
    )
    bins = torch.floor(log_l * (NUM_HISTOGRAM_BINS - 2) + 1.0).to(torch.int32)
    return torch.where(lum < common.EPSILON, 0, bins).to(torch.int32)


def _ema(weighted, black, pixel_count, prev_luminance, delta_time):
    avg_bin = weighted / torch.clamp(pixel_count - black, min=1.0)
    log_l = (avg_bin - 1.0) / (NUM_HISTOGRAM_BINS - 2)
    lum = torch.exp2(log_l * LOG_LUMINANCE_RANGE + MIN_LOG_LUMINANCE)
    dt = torch.as_tensor(delta_time, dtype=torch.float32, device=lum.device)
    t = torch.clamp(1.0 - torch.exp(-dt * EXPOSURE_SMOOTH_TIME), 0.0, 1.0)
    return prev_luminance + (lum - prev_luminance) * t


def average_luminance_direct(hdr_rgb, pixel_count, prev_luminance, delta_time):
    """average_luminance without the histogram: sum of bin indices (exact,
    in int64) and the black-pixel count, then the same EMA."""
    return average_luminance_from_sums(luminance_sums(hdr_rgb), pixel_count, prev_luminance,
                                       delta_time)


def luminance_sums(hdr_rgb) -> torch.Tensor:
    """(2,) int64: the sum of the pixels' histogram bin indices and the
    count of black pixels (bin 0). Integers, so the sums of row bands add
    up to the frame's exactly."""
    bins = luminance_bins(hdr_rgb)
    return torch.stack([bins.sum(dtype=torch.int64), (bins == 0).sum()])


def average_luminance_from_sums(sums, pixel_count, prev_luminance, delta_time):
    """`average_luminance_direct`'s EMA from `luminance_sums` of the frame."""
    return _ema(sums[0].float(), sums[1].float(), pixel_count, prev_luminance, delta_time)


def average_luminance(histogram, pixel_count, prev_luminance, delta_time):
    """EMA-smoothed average luminance (hdr_average_histogram.hlsl:36-71)."""
    idx = torch.arange(NUM_HISTOGRAM_BINS, device=histogram.device)
    weighted = (histogram.long() * idx).sum().float()
    black = histogram[0].float()
    return _ema(weighted, black, pixel_count, prev_luminance, delta_time)


def aces_tone_map(x):
    """ACES fit (hdr_tone_mapping.hlsl:29-39)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tone_map(hdr_rgb, avg_luminance):
    """-> (H, W, 3) display-ready, RGBA8-quantized (hdr_tone_mapping.hlsl:41-52)."""
    l_max = 9.6 * avg_luminance
    mapped = aces_tone_map(hdr_rgb / (l_max + 0.001))
    out = common.encode_gamma(mapped)
    return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0) * (1.0 / 255.0)
