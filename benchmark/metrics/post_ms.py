"""Device ms a captured frame spends after shading: Bloom, AutoExposure,
ToneMapping, Present and the counters' gathering."""


def read(rec):
    p = rec.get("pass_ms")
    if not p:
        return None
    return p["Bloom"] + p["AutoExposure"] + p["ToneMapping"] + p["Present"] + p["stats"]
