"""Bloom (BloomPass::Execute's passes, literally: bright-pass prefilter,
9-tap Gaussian blurs by shifted adds, bilinear resizes), auto-exposure
(hdr_luminance_histogram / hdr_average_histogram) and ACES tone mapping
with gamma 1/2.2 to 8 bits (hdr_tone_mapping.hlsl)."""

from __future__ import annotations

import numpy as np
import torch

GAUSS = (0.0148, 0.0459, 0.1050, 0.1941, 0.2803, 0.1941, 0.1050, 0.0459, 0.0148)
STEPS, THRESHOLD, KNEE = 3, 1.0, 0.5
BINS, MIN_LOG, LOG_RANGE, SMOOTH = 256, -10.0, 12.0, 1.6


def luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def shift(img, dy, dx):
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def blur_h(img):
    return sum(GAUSS[i + 4] * shift(img, 0, i) for i in range(-4, 5))


def blur_v(img):
    return sum(GAUSS[i + 4] * shift(img, i, 0) for i in range(-4, 5))


def resize_matrix(out_n: int, in_n: int, half_phase: bool, device) -> torch.Tensor:
    """(out_n, in_n) bilinear weights with clamp addressing."""
    o = np.arange(out_n, dtype=np.float64)
    p = ((o + 0.5) if half_phase else o) * (in_n / out_n) - 0.5
    i0 = np.floor(p)
    frac = p - i0
    m = np.zeros((out_n, in_n), np.float32)
    np.add.at(m, (o.astype(np.int64), np.clip(i0.astype(np.int64), 0, in_n - 1)),
              (1.0 - frac).astype(np.float32))
    np.add.at(m, (o.astype(np.int64), np.clip(i0.astype(np.int64) + 1, 0, in_n - 1)),
              frac.astype(np.float32))
    return torch.as_tensor(m, device=device)


def resize(img, out_h: int, out_w: int, half_phase: bool = True):
    h, w, c = img.shape
    if out_h != h:
        img = torch.matmul(resize_matrix(out_h, h, half_phase, img.device),
                           img.reshape(h, w * c)).reshape(out_h, w, c)
    if out_w != w:
        img = torch.matmul(resize_matrix(out_w, w, half_phase, img.device), img)
    return img


def bright(color):
    b = color.amax(dim=-1, keepdim=True)
    soft = torch.clamp(b - THRESHOLD + THRESHOLD * KNEE, 0.0, 2 * THRESHOLD * KNEE)
    soft = soft * soft / (4 * THRESHOLD * KNEE + 1e-5)
    return color * (torch.maximum(soft, b - THRESHOLD) / torch.clamp(b, min=1e-5))


def bloom(hdr):
    h, w = hdr.shape[0], hdr.shape[1]

    def size(m):
        return max(1, h >> m), max(1, w >> m)

    base = resize(hdr, *size(1), half_phase=False)
    total = weight = 0.0
    for dy, dx in [(0, 0), (-1, -1), (-1, 1), (1, -1), (1, 1)]:
        c = bright(shift(base, dy, dx))
        wgt = 1.0 / (luminance(c)[..., None] + 1.0)
        total = total + c * wgt
        weight = weight + wgt
    a = {1: total / torch.clamp(weight, min=1e-20)}
    for m in range(1, STEPS + 1):
        a[m + 1] = blur_v(blur_h(resize(a[m], *size(m + 1))))
    for m in range(STEPS, 0, -1):
        a[m] = blur_v(blur_h(a[m]) + blur_h(resize(a[m + 1], *size(m))))
    return hdr + blur_v(blur_h(resize(a[1], h, w)))


def luminance_sums(hdr):
    """(sum of the pixels' histogram bins, count of black pixels), int64."""
    lum = luminance(hdr)
    log_l = torch.clamp((torch.log2(torch.clamp(lum, min=1e-30)) - MIN_LOG) * (1.0 / LOG_RANGE),
                        0.0, 1.0)
    bins = torch.floor(log_l * (BINS - 2) + 1.0).to(torch.int32)
    bins = torch.where(lum < 1e-6, 0, bins)
    return bins.sum(dtype=torch.int64), (bins == 0).sum()


def exposure(sums, pixels: float, prev, delta_time: float):
    """The average luminance's EMA step from the previous frame's `prev`."""
    weighted, black = sums[0].float(), sums[1].float()
    avg_bin = weighted / torch.clamp(pixels - black, min=1.0)
    lum = torch.exp2((avg_bin - 1.0) / (BINS - 2) * LOG_RANGE + MIN_LOG)
    dt = torch.as_tensor(delta_time, dtype=torch.float32, device=lum.device)
    t = torch.clamp(1.0 - torch.exp(-dt * SMOOTH), 0.0, 1.0)
    return prev + (lum - prev) * t


def present(hdr, avg):
    """(H, W, 3) uint8 of the tone-mapped frame."""
    x = hdr / (9.6 * avg + 0.001)
    mapped = torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    out = torch.pow(torch.clamp(mapped, min=0.0), 1.0 / 2.2)
    q = torch.round(torch.clamp(out, 0.0, 1.0) * 255.0) * (1.0 / 255.0)
    return (q * 255.0 + 0.5).to(torch.uint8)
