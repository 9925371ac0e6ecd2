"""Share of the traced window in which no operation ran on a card, the
mean over the band ranks."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
