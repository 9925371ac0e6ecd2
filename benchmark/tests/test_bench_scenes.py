"""The frozen scene generators equal the port's at the port's own draws,
and the scene the harness builds from them packs as the port's own
generators' scene does."""

import numpy as np
import pytest

from benchmark import program
from benchmark.scenes import stress
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.pipeline.scene_pack import pack_scene
from direct12pbrrenderer_tpu_torch.tools import stress_scene

import chip_smoke

SPEC = {"cells_x": 24, "cells_y": 12, "terrain_seed": 3, "texture_size": 256, "texture_seed": 5,
        "albedo_map": True, "sky_size": 16, "sun_dir": [0.4, 0.6, 0.3], "sun_intensity": 80.0}


def test_terrain_and_checker():
    mesh = stress_scene.terrain_mesh(24, 12)
    va = mesh.vertex_array()
    got = stress.terrain(24, 12)
    for k, col in (("position", "positions"), ("normal", "normals"), ("tangent", "tangents"),
                   ("color", "colors"), ("uv", "uvs")):
        np.testing.assert_array_equal(va[k], got[col])
    np.testing.assert_array_equal(mesh.index_array(), got["tris"].reshape(-1))
    assert tuple(mesh.bound_min) == got["bound_min"]
    tex = stress_scene._checker_texture()
    np.testing.assert_array_equal(tex.texture.mip_array(0), stress.checker())


def test_sky():
    want = chip_smoke.procedural_sky(16, (0.4, 0.6, 0.3), 80.0)
    faces = np.stack([f.mip_array_rgba(0)[..., :3] for f in want.cubemap.faces])
    np.testing.assert_array_equal(faces, stress.sky(16, (0.4, 0.6, 0.3), 80.0))


@pytest.mark.parametrize("n_lights", [8, 1024])
def test_packed_scene_equals_the_ports(n_lights):
    """At the port's jitter seed (11) the harness's scene packs bit for bit
    as `chip_smoke.stress_scene`'s (tools/stress_scene with the albedo map
    on and the sky)."""
    want = chip_smoke.stress_scene(24, 12, 16, 80.0, n_lights=n_lights)
    got = program.port_scene(stress.build({**SPEC, "n_lights": n_lights}, 11))
    cfg = RenderConfig(64, 48, max_instances=2, max_lights=1024)
    a, b = pack_scene(want, cfg, 256), pack_scene(got, cfg, 256)
    for k in ("positions", "normals", "tangents", "uvs", "tris", "tri_valid", "model_mats",
              "instance_bounds", "light_pos", "light_color", "light_intensity",
              "light_attenuation", "light_bounds"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    for k in ("data", "page_base", "base_size", "n_mips", "srgb"):
        np.testing.assert_array_equal(getattr(a.atlas, k), getattr(b.atlas, k), err_msg=k)
    np.testing.assert_array_equal(want.skybox.cubemap.sh.as_array(),
                                  got.skybox.cubemap.sh.as_array())
    assert a.light_count == b.light_count == n_lights


def test_seed_moves_only_the_grid_jitter():
    a, b = stress.lights(1024, 1), stress.lights(1024, 2)
    assert not np.array_equal(a["translation"], b["translation"])
    np.testing.assert_array_equal(stress.lights(8, 1)["translation"],
                                  stress.lights(8, 2)["translation"])
