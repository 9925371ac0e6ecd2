"""Kernel G's bound (the frame's clustered point lights at the H100's
peaks) as a share of its device time per frame."""

from benchmark.counts import roofline


def read(rec):
    return roofline(rec, "point_lights_kernel", ibl=False)
