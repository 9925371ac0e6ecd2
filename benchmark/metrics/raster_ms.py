"""Device ms a frame of the GBuffer pass's raster (the row pack and kernel
A, or kernel H and the row gather): the program's span gbuffer.raster
(`benchmark/spans.py`)."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "gbuffer.raster")
