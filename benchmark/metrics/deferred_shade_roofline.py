"""Kernel D's bound (the frame's fused deferred lighting at the H100's
peaks) as a share of its device time per frame."""

from benchmark.counts import roofline


def read(rec):
    return roofline(rec, "deferred_shade_kernel", ibl=True)
