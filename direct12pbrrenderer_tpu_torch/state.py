"""The pipeline state carried across from the JAX package.

The renderer has no weights: its parameters are the pipeline's device
buffers (`pipeline/deferred.py` `buffers`) — the scene pools, the material
rows, the texture atlas, the light arrays and the precompute products — plus
the exposure EMA. `state_from_jax` takes those buffers flattened to numpy
and builds the port's buffers from them, so both packages render from
bit-identical inputs and a comparison isolates the per-frame stages.

Flat key schema (`name` for an array, `name.field` for a structured one):

* arrays: the names in `ARRAY_KEYS`;
* `atlas.data`, `atlas.page_base`, `atlas.base_size`, `atlas.n_mips`,
  `atlas.srgb` (gbuffer.AtlasDevice; `data` as uint32 or its int32 bits);
* `PrecomputeBRDF.quad`, `PrecomputeBRDF.size` (the LUT quad records and
  the LUT side);
* `PrefilterEnvMap.{offsets,sizes_arr,flat}` and
  `SkyBoxTexture.{offsets,sizes_arr,flat}` (common.CubeMipAtlas);
* with the texture-cache path, `EnvCache.data`, `EnvCache.page_base`,
  `EnvCache.base_size`, `EnvCache.n_mips`, `EnvCache.fb_page`,
  `EnvCache.fb_size` (envcache.FloatAtlas: the packed bf16 page atlas and
  its tables), so both packages shade from the same env pages;
* `avg_luminance` (the exposure EMA carry, a scalar).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.common import CubeMipAtlas
from .ops.envcache import FloatAtlas
from .ops.gbuffer import AtlasDevice

ARRAY_KEYS = (
    "positions", "normals", "tangents", "uvs", "vtx_instance", "tris", "tri_material",
    "tri_instance", "tri_valid_pool", "mat_rows", "light_pos", "light_color",
    "light_intensity", "light_attenuation", "ClusterBounds", "SkyBoxSH",
)
ATLAS_FIELDS = AtlasDevice._fields
CUBE_FIELDS = ("offsets", "sizes_arr", "flat")
ENV_FIELDS = FloatAtlas._fields


def state_from_jax(arrays: dict[str, np.ndarray], device) -> dict:
    """-> the port's buffers dict (plus "avg_luminance") on `device`."""
    def t(key):
        return torch.as_tensor(np.array(arrays[key]), device=device)

    out = {k: t(k) for k in ARRAY_KEYS}
    out["atlas"] = AtlasDevice.from_numpy(
        *(arrays[f"atlas.{f}"] for f in ATLAS_FIELDS), device=device)
    out["PrecomputeBRDF"] = (t("PrecomputeBRDF.quad"), int(arrays["PrecomputeBRDF.size"]))
    for name in ("PrefilterEnvMap", "SkyBoxTexture"):
        out[name] = CubeMipAtlas(*(t(f"{name}.{f}") for f in CUBE_FIELDS))
    if "EnvCache.data" in arrays:
        out["EnvCache"] = FloatAtlas.from_numpy(
            *(arrays[f"EnvCache.{f}"] for f in ENV_FIELDS), device=device)
    out["avg_luminance"] = torch.as_tensor(np.array(arrays["avg_luminance"], np.float32),
                                           device=device)
    return out
