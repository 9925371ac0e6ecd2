"""Mean device ms between frames, from a frame's last mark to the next
frame's first, over the traced frames (`benchmark/spans.py`; each seam is
named on standard error by the program's host span open at its start)."""

from benchmark.spans import seam_ms


def read(rec):
    return seam_ms(rec)
