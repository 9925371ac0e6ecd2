"""Device ms a frame of the anisotropic sampler's footprint (the gradients
in texels, the ratio, the lod and the major axis): the program's span
gbuffer.aniso_footprint (`benchmark/spans.py`)."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "gbuffer.aniso_footprint")
