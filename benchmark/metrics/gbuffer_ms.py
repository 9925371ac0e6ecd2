"""Device ms a captured frame spends in Cull and GBuffer (geometry,
binning, raster, texture plan and resolve)."""


def read(rec):
    p = rec.get("pass_ms")
    return None if not p else p["Cull"] + p["GBuffer"]
