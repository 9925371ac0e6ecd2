"""Device ms a frame of the anisotropic sampler's taps (the trilinear taps
along the major axis, their sum and scale): the program's span
gbuffer.aniso_taps (`benchmark/spans.py`)."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "gbuffer.aniso_taps")
