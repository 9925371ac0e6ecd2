"""Device ms a captured frame spends in Clustered, DeferredShading and
Skybox (light rows, env plan and resolve, SH, split-sum, point lights)."""


def read(rec):
    p = rec.get("pass_ms")
    return None if not p else p["Clustered"] + p["DeferredShading"] + p["Skybox"]
