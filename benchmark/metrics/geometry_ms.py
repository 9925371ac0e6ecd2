"""Device ms a frame of the GBuffer pass's geometry stage (vertex
transform, triangle setup, vertex attributes): the program's span
gbuffer.geometry, the mean over the traced frames (`benchmark/spans.py`)."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "gbuffer.geometry")
