"""The anisotropic sampler's bound (its texture samples at the H100's
peaks) as a share of its device time per frame: the spans
gbuffer.aniso_footprint and gbuffer.aniso_taps (`benchmark/spans.py`).

The work is counted from the reference's counts at the first traced pose
(`tex_samples`, `tex_taps`) and the reference's formula
(`benchmark/reference/texture.py`, `MipTexture.anisotropic`), never from
the program's buffers or counters. Bytes: each sample's RGBA written once
as float32; the texels are left out, as a cache holds them. Operations:
the filter's arithmetic, a transcendental (sqrt, log2, pow) as one, the
wrap addressing and the unpacking of a storage format not counted. Only
hardware texture filtering, which does a tap's weights and blends in its
texture units, could do less arithmetic than this; the bound is far below
any software sampler's time, so the share reads as a fraction of 1%.
"""

from benchmark.counts import bound
from benchmark.spans import span_ms

# One trilinear tap: the tap's offset along the major axis (2 multiplies,
# 2 adds) 4; the lod's clamp, floor and fraction 4; two bilinear samples of
# 54 each (texel coordinates 4, floors 2, fractions 2; the weights' 1 - fx,
# 1 - fy 2; four corner terms of 2 multiplies on 4 channels 32; their 3
# adds on 4 channels 12) 108; the mip blend (1 - frac, 8 multiplies, 4
# adds) 13; the sRGB decode of 3 channels (clamp 2, compare, divide, add,
# divide, pow, select) 24; the sum of the four taps (3 adds on 4 channels)
# shared among them 3.
ANISO_TAP_OPS = 4 + 4 + 108 + 13 + 24 + 3
# One sample's footprint: the gradients in texels (4 multiplies), their
# squared lengths (4 multiplies, 2 adds) 6, the major squared length 1, the
# minor's min and clamp 2, the ratio's divide, sqrt and clamp 4, the lod's
# clamp, two log2, multiply and subtract 5, the background's select 1, the
# axis's compare and 2 selects 3; then the sum's 1/4 scale on 4 channels 4.
ANISO_FOOTPRINT_OPS = 4 + 6 + 1 + 2 + 4 + 5 + 1 + 3 + 4


def work(c: dict) -> tuple[float, float]:
    """(bytes, flops) of the sampler's frame from the reference's counts."""
    return (16.0 * c["tex_samples"],
            float(ANISO_TAP_OPS * c["tex_taps"] + ANISO_FOOTPRINT_OPS * c["tex_samples"]))


def read(rec):
    c = rec.get("counts")
    if not c:
        return None
    foot = span_ms(rec, "gbuffer.aniso_footprint")
    taps = span_ms(rec, "gbuffer.aniso_taps")
    if foot is None or taps is None or foot + taps <= 0:
        return None
    t, _ = bound(*work(c))
    return 100.0 * t / (foot + taps)
