"""Device ms a frame of the GBuffer pass's binning of triangles to tiles:
the program's span gbuffer.binning (`benchmark/spans.py`)."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "gbuffer.binning")
