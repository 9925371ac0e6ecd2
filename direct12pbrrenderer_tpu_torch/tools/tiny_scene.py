"""The smoke scene: one lit sphere — the port's counterpart of
`__graft_entry__._tiny_pipeline`, built from the port's own resource, scene
and pipeline modules with the same scene, config, knobs and camera.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..pipeline.deferred import DeferredRenderPipeline
from ..resource.default_meshes import sphere_mesh
from ..resource.resources import MaterialResource, MeshResource, ModelResource
from ..scene.camera import Camera
from ..scene.scene import Scene, SceneLight, SceneModel


def tiny_pipeline(device: torch.device | str, width: int = 128, height: int = 96,
                  tile_h: int = 12, tile_w: int = 64):
    """(pipeline, camera, config): a 16x12 sphere (albedo (0.8, 0.3, 0.2),
    roughness 0.4) under one light at (2, 2, -2) (intensity 60, radius 4),
    seen from (0, 0, 4) at yaw pi, on `device`."""
    mesh_res = MeshResource("mem/sphere", "mem/sphere_data")
    mesh_res.mesh = sphere_mesh(1.0, 16, 12)
    mat = MaterialResource("mem/mat")
    mat.set_parameter("Albedo", np.array([0.8, 0.3, 0.2], np.float32))
    mat.set_parameter("Roughness", 0.4)
    model = ModelResource("mem/model", mesh_res, [mat])
    scene = Scene("mem/scene")
    sm = SceneModel("ball")
    sm.set_model(model)
    sm.update_transform()
    scene.add_model(sm)
    light = SceneLight("key")
    light.translation = np.array([2.0, 2.0, -2.0], np.float32)
    light.update_transform()
    light.set_intensity(60.0)
    light.set_radius(4.0)
    scene.add_light(light)

    cfg = RenderConfig(width=width, height=height, max_triangles=2048, max_vertices=2048,
                       max_instances=4, max_lights=16)
    pipe = DeferredRenderPipeline(scene, cfg, tile_h=tile_h, tile_w=tile_w, bin_cap=512,
                                  prefilter_size=16, brdf_lut_size=32, device=device)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)
    return pipe, cam, cfg
