"""Device ms a frame of the planar texture cache's resolve (kernel E,
`csrc/atlas_resolve.cu`): the program's span gbuffer.atlas_resolve inside
gbuffer.tex_resolve (`benchmark/spans.py`)."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "gbuffer.atlas_resolve")
