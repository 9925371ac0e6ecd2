"""The card's peaks and the work a pass must do, counted from the frame's
own data (pixels, covered pixels, lit pixel-light pairs from the
reference's cluster lists), never from an implementation's buffers."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores
CLUSTERS = 24 * 16 * 8
PIXEL_OPS = 100             # a covered pixel's SH irradiance and split-sum
PAIR_OPS = 100              # one light's Cook-Torrance term at one pixel
SPHERE_OPS = 18             # one cluster-vs-light-sphere test


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for moving `n_bytes` (each input read and
    each output written once) and doing `flops` float32 operations."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def deferred_work(c: dict, ibl: bool) -> tuple[float, float]:
    """(bytes, flops) of lighting a frame: every pixel's depth read and its
    3 HDR words written; a covered pixel's G-buffer (albedo 3, normal 2,
    roughness, metallic, and with `ibl` emission too) read; each lit pair's
    light term; every cluster tested against every light row; with `ibl`,
    each covered pixel's environment terms."""
    words = c["pixels"] * (1 + 3) + c["covered"] * (8 if ibl else 7)
    flops = (PAIR_OPS * c["lit_pairs"] + SPHERE_OPS * CLUSTERS * c["lights"]
             + (PIXEL_OPS * c["covered"] if ibl else 0))
    return 4.0 * words, float(flops)


def roofline(rec: dict, kernel: str, ibl: bool):
    """Share (%) of the kernel's device time per frame that its bound is,
    or None where the trace holds no launch of it."""
    ms = rec["kernel_ms"].get(kernel)
    if not ms:
        return None
    t, _ = bound(*deferred_work(rec["counts"], ibl))
    return 100.0 * t / ms
