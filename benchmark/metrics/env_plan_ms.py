"""Device ms a frame of DeferredShading's env plan (the env taps' groups,
their addresses, kernel B's covers and the staged pages, before kernel D
or F): the program's span shade.env_plan (`benchmark/spans.py`)."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "shade.env_plan")
