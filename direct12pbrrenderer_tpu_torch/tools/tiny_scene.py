"""The smoke scene: one lit sphere — the port's counterpart of
`__graft_entry__._tiny_pipeline`, built from the port's own resource, scene
and pipeline modules with the same scene, config, knobs and camera — and
`dryrun_multichip`, the counterpart of `__graft_entry__.dryrun_multichip`.
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
                  tile_h: int = 12, tile_w: int = 64, **knobs):
    """(pipeline, camera, config): a 16x12 sphere (albedo (0.8, 0.3, 0.2),
    roughness 0.4) under one light at (2, 2, -2) (intensity 60, radius 4),
    seen from (0, 0, 4) at yaw pi, on `device`; `knobs` override the
    pipeline's (bin_cap 512, prefilter_size 16, brdf_lut_size 32)."""
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
    knobs = dict(dict(bin_cap=512, prefilter_size=16, brdf_lut_size=32), **knobs)
    pipe = DeferredRenderPipeline(scene, cfg, tile_h=tile_h, tile_w=tile_w, device=device,
                                  **knobs)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, np.pi, 0)
    return pipe, cam, cfg


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One band frame of the tiny scene's fused pipeline (tile 8x128, width
    128, bin_cap 256, height 16 rows a rank but at least 64: the JAX dryrun's
    32-row frame for two ranks is nearly black, lit 0.002 in both packages,
    and fails its own lit check) on n spawned ranks
    (`frame_sharded.launch`: NCCL with a card a rank, gloo on a shared card
    or the CPU), held to the single-device render of the same pose: rmse
    <= 1e-3 on uint8/255 and a lit share above 0.05. Prints the backend and
    one line; a failing rank or check raises. `device="cpu"` runs the
    kernels' plain versions."""
    from ..parallel import frame_sharded

    print(f"dryrun_multichip({n_devices}): backend "
          f"{frame_sharded.backend_for(n_devices, device)} on {device}", flush=True)
    line = frame_sharded.launch(n_devices, _dryrun_rank, device=device)[0]
    print(line, flush=True)


def _dryrun_rank(mesh) -> str | None:
    tile_h, n = 8, mesh.size
    height, width = max(n * tile_h * 2, 64), 128
    pipe, cam, _ = tiny_pipeline(mesh.device, width=width, height=height, tile_h=tile_h,
                                 tile_w=128, bin_cap=256, use_pallas=True, use_tex_kernel=True)
    if not pipe.use_fused_gbuffer:
        raise RuntimeError("the dryrun must run the fused path")
    from ..parallel import frame_sharded

    frame = frame_sharded.build_sharded_frame(mesh, pipe)
    band, avg = frame(*frame_sharded.frame_args(pipe, cam))
    out = frame_sharded.gather_rows(mesh, band).cpu().numpy()
    if mesh.rank:
        return None
    ref = pipe.render(cam).cpu().numpy()   # the single-device frame of the same pose
    if out.shape != (height, width, 3) or out.dtype != np.uint8 or not float(avg) >= 0.0:
        raise RuntimeError(f"bad band frame: {out.shape} {out.dtype}, avg {float(avg)}")
    lit_frac = float((ref.max(-1) > 16).mean())
    if lit_frac <= 0.05:
        raise RuntimeError(f"dryrun frame nearly empty (lit {lit_frac:.3f})")
    rmse = float(np.sqrt(np.mean((out.astype(np.float64) - ref.astype(np.float64)) ** 2))) / 255.0
    if rmse > 1e-3:
        raise RuntimeError(f"sharded-vs-single rmse {rmse:.6f} > 1e-3")
    return (f"dryrun_multichip({n}): frame {out.shape} ok, mean={out.mean():.2f}, "
            f"lit_frac={lit_frac:.3f}, sharded_vs_single_rmse={rmse:.6f}, "
            f"avg_lum={float(avg):.5f}")
