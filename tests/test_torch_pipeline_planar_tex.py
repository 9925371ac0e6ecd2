"""The port's frames through the planar texture-cache G-buffer, the
anisotropic filter and the two-kernel cover, against the JAX pipeline with
the same knobs (`pallas_interpret=True`), on a small textured scene:
`tools/stress_scene` with its albedo map switched on and a sky, so the
texture cache, the env cache and their kernels all do work.

The JAX pipeline's buffers are carried across (state.state_from_jax), so
both render from bit-identical inputs; each frame must meet the JAX
package's fidelity bar (rmse <= 1e-3 on uint8/255, the largest difference
is reported in the assertion) with identical FrameStats, and each case
asserts which kernels' wrappers the frame called:

(a) tests/test_pipeline.py's planar-cache configuration: tile 60x160,
    bin_cap 256, `use_tex_kernel=True`, `use_pallas=False` (the plain
    raster, the row gather, the cache on its own 20x160 tiling: kernels B,
    E; the unfused deferred pass with the env cache: B, F);
(b) `use_pallas=True, use_tex_kernel=True` at a 24x64 raster tile (not 128
    wide: kernel A's planes feed the planar cache, kernels B, E, F);
(c) `texture_filter="anisotropic"` with `use_tex_kernel=True` at 24x128
    (kernel A, the anisotropic sampler, the env cache B, F; no E);
(d) the fused path with `tex_caps=(156, 44)`: the lo-half texture cover
    goes through kernel I, the other covers through B, then C and D.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from chip_smoke import recording
from direct12pbrrenderer_tpu.config import RenderConfig
from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JaxPipeline
from direct12pbrrenderer_tpu.resource.resources import CubeMapResource
from direct12pbrrenderer_tpu.scene.camera import Camera
from direct12pbrrenderer_tpu.tools.stress_scene import build_stress_scene
from direct12pbrrenderer_tpu_torch.ops import (atlas_resolve_cuda, cover_cuda,
                                               env_resolve_cuda, raster_cuda,
                                               resolve_shade_cuda, shade_fused)
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.state import state_from_jax
from test_env_isolation import _sky_cube
from test_torch_pipeline import _rmse, jax_state

torch.set_num_threads(2)
RMSE_BAR = 1e-3
BASE = dict(prefilter_size=16, brdf_lut_size=32, atlas_max_dim=64)

# name -> (width, height, knobs, {kernel wrapper: calls in one frame}); "wide"
# counts the fused_cover calls at a cap above 128 (kernel I)
CASES = {
    "a_no_pallas_60x160": (320, 120, dict(tile_h=60, tile_w=160, bin_cap=256,
                                          use_pallas=False, use_tex_kernel=True),
                           dict(atlas_resolve=1, env_resolve=1, fused_cover=4,
                                rasterize_interp=0, rasterize_depth=0, wide=0)),
    "b_pallas_24x64": (256, 96, dict(tile_h=24, tile_w=64, bin_cap=256, use_pallas=True,
                                     use_tex_kernel=True),
                       dict(atlas_resolve=1, env_resolve=1, fused_cover=4,
                            rasterize_interp=1, resolve_shade=0, wide=0)),
    "c_anisotropic": (256, 96, dict(tile_h=24, tile_w=128, bin_cap=256, use_pallas=True,
                                    use_tex_kernel=True, texture_filter="anisotropic"),
                      dict(atlas_resolve=0, env_resolve=1, fused_cover=1,
                           rasterize_interp=1, resolve_shade=0, wide=0)),
    "d_fused_cap156": (256, 96, dict(tile_h=24, tile_w=128, bin_cap=256, use_pallas=True,
                                     use_tex_kernel=True, tex_caps=(156, 44)),
                       dict(atlas_resolve=0, env_resolve=0, fused_cover=4, wide=1,
                            resolve_shade=1, deferred_kernel=1)),
}
WRAPPERS = {"atlas_resolve": atlas_resolve_cuda, "env_resolve": env_resolve_cuda,
            "fused_cover": cover_cuda, "rasterize_interp": raster_cuda,
            "rasterize_depth": raster_cuda, "resolve_shade": resolve_shade_cuda,
            "deferred_kernel": shade_fused}


def _scene(width, height):
    scene = build_stress_scene(cells_x=16, cells_y=8)
    for sm in scene.models:
        for mat in sm.model.materials:
            mat.set_parameter("UseAlbedoMap", True)
    sky = CubeMapResource("mem/sky")
    sky.cubemap = _sky_cube(16)
    scene.set_skybox(sky)
    cfg = RenderConfig(width=width, height=height, max_instances=2, max_lights=16,
                       max_triangles=2048, max_vertices=2048)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 4, 10])
    cam.rotate(0, math.pi, 0.3)
    return scene, cfg, cam


@pytest.mark.parametrize("case", list(CASES))
def test_planar_tex_frame_matches_jax(case):
    width, height, knobs, want_calls = CASES[case]
    scene, cfg, cam = _scene(width, height)
    jp = JaxPipeline(scene, cfg, pallas_interpret=True, **BASE, **knobs)
    state = jax_state(jp)
    want = np.asarray(jp.render(cam))
    tp = DeferredRenderPipeline(scene, cfg, device="cpu", **BASE, **knobs)
    for p in (jp, tp):
        assert p.use_tex_kernel and p.use_fused_gbuffer == case.startswith("d_")
        assert p.use_fused_deferred == case.startswith("d_")
    tp.load_state(state_from_jax(state, "cpu"))
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(recording(mod, name))
                 for name, mod in WRAPPERS.items()}
        got = tp.render(cam).numpy()
    calls["wide"] = [c for c in calls["fused_cover"] if max(c[0][2]) > cover_cuda.WIDE_CAP]
    assert {k: len(calls[k]) for k in want_calls} == want_calls
    assert got.shape == want.shape and (want.max(-1) > 16).mean() > 0.05
    rmse = _rmse(got, want)
    max_diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    assert rmse <= RMSE_BAR, (rmse, max_diff)
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats), max_diff
    # the frame really samples a texture: the albedo map is packed and used
    assert tp.packed.materials.use_map[:, 0].any() and len(tp.packed.atlas.n_mips) >= 1
