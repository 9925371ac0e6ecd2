"""The system under test: the port's `DeferredRenderPipeline`, built from a
cell's configuration and the frozen scene arrays, and its camera path.

The harness takes from the program only this, the loops' `render` and
band-frame calls (`run.py`, `bands.py`) and, in a traced run, its frame
graph's passes and `eager()`; the reference takes nothing of it.
"""

from __future__ import annotations

import math

import numpy as np


def fov(render: dict) -> float:
    return render["fov_pi"] * math.pi


def port_scene(data: dict):
    """The port's Scene of the frozen arrays, built through its resource and
    scene layers as `tools/stress_scene.build_stress_scene` builds it, with
    the albedo map's use flag set and the sky attached."""
    from direct12pbrrenderer_tpu_torch.resource.formats import ETextureFormat
    from direct12pbrrenderer_tpu_torch.resource.resources import (
        CubeMapResource, MaterialResource, MeshResource, ModelResource, TextureResource)
    from direct12pbrrenderer_tpu_torch.resource.storage import (
        STANDARD_VERTEX_DTYPE, CubeMapTextureData, EVertexFormat, MeshData, TextureData)
    from direct12pbrrenderer_tpu_torch.scene.scene import Scene, SceneLight, SceneModel

    m = data["mesh"]
    verts = np.zeros(len(m["positions"]), dtype=STANDARD_VERTEX_DTYPE)
    for k, col in (("position", "positions"), ("normal", "normals"), ("tangent", "tangents"),
                   ("color", "colors"), ("uv", "uvs")):
        verts[k] = m[col]
    mesh_res = MeshResource("mem/terrain", "mem/terrain_data")
    mesh_res.mesh = MeshData.from_arrays(EVertexFormat.P3F_N3F_T3F_C3F_T2F, verts,
                                         m["tris"].reshape(-1), None, m["bound_min"],
                                         m["bound_max"])
    mp = data["material"]
    mat = MaterialResource("mem/terrain_mat")
    mat.set_shader("gbuffer.hlsl")
    mat.set_parameter("Albedo", np.asarray(mp["albedo"], np.float32))
    mat.set_parameter("Roughness", mp["roughness"])
    mat.set_parameter("Metallic", mp["metallic"])
    tex = TextureResource("mem/terrain_albedo")
    tex.texture = TextureData.from_array(data["albedo_map"], ETextureFormat.R8G8B8A8_UNORM_SRGB)
    mat.set_texture("AlbedoMap", tex)
    mat.set_parameter("UseAlbedoMap", mp["albedo_map"])
    model = ModelResource("mem/terrain_model", mesh_res, [mat])
    scene = Scene("mem/stress_scene")
    sm = SceneModel("terrain")
    sm.set_model(model)
    sm.translation = np.array([0, 0, 0], np.float32)
    sm.update_transform()
    sm.local_bound_min, sm.local_bound_max = model.bound
    scene.add_model(sm)
    lg = data["lights"]
    for i in range(len(lg["intensity"])):
        light = SceneLight(f"light{i}")
        light.translation = lg["translation"][i].copy()
        light.update_transform()
        light.color = lg["color"][i].copy()
        light.set_intensity(float(lg["intensity"][i]))
        light.set_radius(float(lg["radius"][i]))
        scene.add_light(light)
    sky = data["sky"]
    faces = [TextureData.from_array(np.concatenate([f, np.ones_like(f[..., :1])], -1),
                                    ETextureFormat.R32G32B32A32_FLOAT) for f in sky]
    res = CubeMapResource("mem/sky")
    res.cubemap = CubeMapTextureData(faces=faces)
    scene.set_skybox(res)
    return scene


def render_config(cfg: dict):
    from direct12pbrrenderer_tpu_torch.config import RenderConfig

    r = cfg["render"]
    kw = {"max_lights": r["max_lights"]} if r.get("max_lights") else {}
    return RenderConfig(r["width"], r["height"], fov=fov(r), near=r["near"], far=r["far"],
                        max_instances=r["max_instances"], **kw)


def knobs(cfg: dict) -> dict:
    """The pipeline's keyword arguments (lists in JSON become tuples)."""
    def tup(x):
        return tuple(tup(v) for v in x) if isinstance(x, list) else x
    return {k: tup(v) for k, v in cfg["pipeline"].items()}


def pipeline(cfg: dict, scene, device, **override):
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    return DeferredRenderPipeline(scene, render_config(cfg), device=device,
                                  **{**knobs(cfg), **override})


def camera(cfg: dict, pose: dict):
    """The port's fly camera at `pose` (position, then yaw and pitch)."""
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera

    r = cfg["render"]
    cam = Camera(fov(r), r["width"], r["height"], r["near"], r["far"])
    cam.move(pose["position"])
    cam.rotate(0.0, pose["yaw"], pose["pitch"])
    return cam
