"""The planar texture cache's resolve (kernel E) at its bound (its texture
samples at the H100's peaks) as a share of its device time per frame: the
span gbuffer.atlas_resolve (`benchmark/spans.py`).

The work is counted from the reference's counts at the first traced pose
(`tex_samples`, `tex_taps`) and the reference's formula
(`benchmark/reference/texture.py`, `MipTexture.trilinear`), never from the
program's buffers or counters. Bytes: each sample's RGBA written once as
float32; the texels are left out, as a cache holds them, and so are the
slots the material does not sample, which a resolve need not write. The
sRGB decode runs after the span, so it is not counted. Operations: a
tap's arithmetic, the wrap addressing and the unpacking of a storage
format not counted.
"""

from benchmark.counts import bound
from benchmark.spans import span_ms

# One trilinear tap: the lod's clamp, floor and fraction 4; two bilinear
# samples of 54 each (texel coordinates 4, floors 2, fractions 2; the
# weights' 1 - fx, 1 - fy 2; four corner terms of 2 multiplies on 4
# channels 32; their 3 adds on 4 channels 12) 108; the mip blend (1 - frac,
# 8 multiplies, 4 adds) 13.
TRILINEAR_TAP_OPS = 4 + 108 + 13


def work(c: dict) -> tuple[float, float]:
    """(bytes, flops) of the resolve's frame from the reference's counts."""
    return 16.0 * c["tex_samples"], float(TRILINEAR_TAP_OPS * c["tex_taps"])


def read(rec):
    c = rec.get("counts")
    if not c:
        return None
    ms = span_ms(rec, "gbuffer.atlas_resolve")
    if not ms:
        return None
    t, _ = bound(*work(c))
    return 100.0 * t / ms
