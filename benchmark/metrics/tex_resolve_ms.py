"""Device ms a frame of the texture resolve and pixel shade (kernel C, or
E, and the G-buffer's untile): the program's span gbuffer.tex_resolve
(`benchmark/spans.py`)."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "gbuffer.tex_resolve")
