"""Device ms a frame of the texture cache's plan (the taps' LOD and
addresses, kernel B's page covers, the staged-page block): the program's
span gbuffer.tex_plan (`benchmark/spans.py`)."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "gbuffer.tex_plan")
