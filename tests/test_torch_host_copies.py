"""The port's own copies of the JAX package's host modules (`config`,
`graph/frame_graph`, `utils/`, `scene/`, `resource/`, `pipeline/scene_pack`,
`tools/stress_scene`) against the originals:

* the port's `build_stress_scene` (16x8 cells with 8 and with 72 lights, with
  and without a sky) packs to `PackedScene` arrays bit-equal to the JAX
  package's, and the sky's SH pack is bit-equal;
* the port's `Camera` gives the same view, projection and frustum planes;
* `RenderConfig` defaults and the engine constants are equal;
* the frame graph orders the port pipeline's passes as the JAX package's
  graph orders its own, with the same lifetimes.
"""

import copy
import dataclasses
import importlib
import math

import numpy as np
import pytest

import direct12pbrrenderer_tpu.config as jconfig
import direct12pbrrenderer_tpu_torch.config as tconfig
from direct12pbrrenderer_tpu.graph import frame_graph as jfg
from direct12pbrrenderer_tpu.pipeline.scene_pack import pack_scene as jpack
from direct12pbrrenderer_tpu.scene.camera import Camera as JCamera
from direct12pbrrenderer_tpu_torch.graph import frame_graph as tfg
from direct12pbrrenderer_tpu_torch.pipeline.scene_pack import pack_scene as tpack
from direct12pbrrenderer_tpu_torch.scene.camera import Camera as TCamera


def _module(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _sky(pkg, size=8):
    """A small HDR cubemap built with `pkg`'s own resource classes."""
    fmt = _module(pkg, "resource.formats").ETextureFormat
    storage = _module(pkg, "resource.storage")
    rng = np.random.default_rng(0)
    faces = [storage.TextureData.from_array(
        rng.uniform(0.0, 4.0, (size, size, 4)).astype(np.float32), fmt.R32G32B32A32_FLOAT)
        for _ in range(6)]
    res = _module(pkg, "resource.resources").CubeMapResource("mem/sky")
    res.cubemap = storage.CubeMapTextureData(faces=faces)
    return res


def _stress(pkg, n_lights, sky):
    scene = _module(pkg, "tools.stress_scene").build_stress_scene(16, 8, n_lights=n_lights)
    if sky:
        scene.set_skybox(_sky(pkg))
    return scene


@pytest.mark.parametrize("sky", [False, True])
@pytest.mark.parametrize("n_lights", [8, 72])
def test_stress_scene_packs_bit_equal(n_lights, sky):
    cfg_t = tconfig.RenderConfig(128, 96, max_instances=2, max_lights=128)
    cfg_j = jconfig.RenderConfig(128, 96, max_instances=2, max_lights=128)
    ts = _stress("direct12pbrrenderer_tpu_torch", n_lights, sky)
    js = _stress("direct12pbrrenderer_tpu", n_lights, sky)
    for mats in (sm.model.materials for s in (ts, js) for sm in s.models):
        for m in mats:
            m.set_parameter("UseAlbedoMap", True)   # pack the albedo map too
    got, want = tpack(ts, cfg_t, 64), tpack(js, cfg_j, 64)
    assert got.light_count == want.light_count == n_lights
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif dataclasses.is_dataclass(b) or hasattr(b, "_fields"):
            for k in (b._fields if hasattr(b, "_fields") else
                      [x.name for x in dataclasses.fields(b)]):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        elif b is not None and not hasattr(b, "width"):
            assert a == b, f.name
    assert got.atlas.data.size > 0
    if sky:
        np.testing.assert_array_equal(ts.skybox.cubemap.sh.as_array(),
                                      js.skybox.cubemap.sh.as_array())
    # the port packs the JAX package's scene objects the same way (by attribute)
    np.testing.assert_array_equal(tpack(js, cfg_t, 64).light_pos, want.light_pos)


def test_camera_matches():
    cams = [JCamera(math.pi / 3, 256, 96, 0.1, 100.0), TCamera(math.pi / 3, 256, 96, 0.1, 100.0)]
    for step in [([0, 6, 18], (0, math.pi, 0.35)), ([1, -2, 3], (0.1, 0.4, -0.2)),
                 ([0, 0, 0], (0, 0.002, 0))]:
        for c in cams:
            c.move(step[0])
            c.rotate(*step[1])
        for fn in ("view_matrix", "projection_matrix", "world_matrix", "frustum_planes"):
            np.testing.assert_array_equal(getattr(cams[1], fn)(), getattr(cams[0], fn)(),
                                          err_msg=fn)
        np.testing.assert_array_equal(cams[1].position, cams[0].position)
    # a deep copy rotates on its own (chip_smoke's camera paths rely on it)
    c2 = copy.deepcopy(cams[1])
    c2.rotate(0, 0.1, 0)
    assert not np.array_equal(c2.view_matrix(), cams[1].view_matrix())


def test_render_config_and_constants_match():
    assert dataclasses.asdict(tconfig.RenderConfig()) == dataclasses.asdict(jconfig.RenderConfig())
    cfg_t, cfg_j = tconfig.RenderConfig(1920, 1080), jconfig.RenderConfig(1920, 1080)
    assert (cfg_t.ratio, cfg_t.fov, cfg_t.near, cfg_t.far) == (
        cfg_j.ratio, cfg_j.fov, cfg_j.near, cfg_j.far)
    names = [n for n in dir(jconfig) if n.isupper()]
    assert names and all(hasattr(tconfig, n) for n in names)
    for n in names:
        a, b = getattr(tconfig, n), getattr(jconfig, n)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), n
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=n)


def test_frame_graph_orders_passes_alike():
    """The port pipeline's ten passes compiled by both graph modules: same
    order, lifetimes and dead-after-use sets; and the same order as the JAX
    pipeline's own graph."""
    import __graft_entry__ as graft
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    jpipe, _, cfg = graft._tiny_pipeline()
    tpipe = DeferredRenderPipeline(jpipe.scene, cfg, tile_h=12, tile_w=64, bin_cap=512,
                                   prefilter_size=8, brdf_lut_size=16, device="cpu")
    passes = tpipe.graph.order
    got = tfg.compile_graph(passes, present="Present")
    want = jfg.compile_graph([jfg.RenderPass(p.name, p.reads, p.writes, p.fn, p.declares)
                              for p in passes], present="Present")
    assert [p.name for p in got.order] == [p.name for p in want.order]
    assert got.lifetimes == want.lifetimes and got.donatable == want.donatable
    assert [p.name for p in got.order] == [p.name for p in jpipe.graph.order]


def test_serialized_textures_raise_naming_their_roadmap_item():
    """The asset-tree form of a texture (BC-compressed payloads) raised,
    naming ROADMAP module item 9, until that item was ported: both entry
    points now give the JAX package's payload bytes and decoded pixels."""
    from direct12pbrrenderer_tpu.resource import storage as jstorage
    from direct12pbrrenderer_tpu_torch.resource.formats import ETextureFormat
    from direct12pbrrenderer_tpu_torch.resource.storage import TextureData

    img = np.random.default_rng(0).integers(0, 256, (8, 8, 4), np.uint8)
    tex = TextureData.from_array(img, ETextureFormat.R8G8B8A8_UNORM)
    want = jstorage.TextureData.from_array(img, ETextureFormat.R8G8B8A8_UNORM)
    assert tex.mip_levels == 4 and tex.mip_array_rgba(3).shape == (1, 1, 4)
    payload = tex.compress_payload()
    assert payload == want.compress_payload() and len(payload) == 8 * (4 + 1 + 1 + 1)
    got = TextureData.from_compressed(8, 8, 1, 4, ETextureFormat.R8G8B8A8_UNORM, payload)
    back = jstorage.TextureData.from_compressed(8, 8, 1, 4, ETextureFormat.R8G8B8A8_UNORM,
                                                payload)
    for mip in range(4):
        np.testing.assert_array_equal(got.mip_array_rgba(mip), back.mip_array_rgba(mip))
