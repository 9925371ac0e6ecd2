"""Host seconds of the first `render`: the warm-up frames, kernel builds
and the graph capture."""


def read(rec):
    return rec.get("capture_s")
