"""Texture-cache page-budget census — counterpart of `tools/tap_census.py`.

Renders a scene's tap stream through the exact addressing of the caches
(`gbuffer.tap_query` + `texcache.tap_census`, and the env cache's tap groups
through `envcache.tap_census`) over a sweep of camera poses, and reports
the realized distinct-page demand per trilinear half with a SEG_CHUNK-aligned
(cap_lo, cap_hi) to pass to `DeferredRenderPipeline(tex_caps=...)`. The
pipeline's `tex_caps="auto"` runs it once, before its first frame.

Differences from the JAX package's module:
* the raster runs `stages.rasterize(use_pallas=pipe.use_pallas,
  raster_caps=pipe.raster_caps)`: on the card the depth-only kernel H, which
  gives the plain fold's ids and depths bit for bit (the JAX package calls
  the plain fold);
* `tap_query` takes the indexed size lookup of the kernel path on a CUDA
  device (the JAX package: on an accelerator); both lookups are exact;
* `census_for_pose` and `env_census_for_pose` pass the band height and
  y_offset 0 of the port's `stages` signatures;
* the env atlas is the pipeline's `buffers["EnvCache"]`;
* `main()` takes `--device` (default `cuda`) for the port's `App`.

    python -m direct12pbrrenderer_tpu_torch.tools.tap_census --asset-root DIR \
        [--width W --height H] [--poses N] [--headroom X] [--device D]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def _frame_geometry(pipe, camera):
    """The GBuffer pass's front end for `camera`: (setup, vattrs, tri_id,
    depth) on the pipeline's render canvas."""
    from ..pipeline import stages

    dev = pipe.device
    w, h = pipe.render_w, pipe.render_h
    p = pipe.packed
    planes = camera.frustum_planes()
    model_mats = torch.as_tensor(p.model_mats, dtype=torch.float32, device=dev)
    normal_mats = torch.as_tensor(
        np.ascontiguousarray(np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1))),
        dtype=torch.float32, device=dev)
    visible = torch.as_tensor(p.instance_visibility(planes), device=dev)
    view_proj = torch.as_tensor(
        np.asarray(camera.projection_matrix() @ camera.view_matrix(), np.float32), device=dev)
    setup, vattrs = stages.geometry(pipe.buffers, model_mats, normal_mats, visible, view_proj,
                                    w, h)
    bins = stages.binning(setup, w, h, pipe.tile_h, pipe.tile_w, pipe.bin_cap)
    tri_id, depth = stages.rasterize(setup, bins, w, h, pipe.tile_h, pipe.tile_w,
                                     use_pallas=pipe.use_pallas, raster_caps=pipe.raster_caps)
    return setup, vattrs, tri_id, depth


def census_for_pose(pipe, camera):
    """One frame's tap census dict (see texcache.tap_census)."""
    from ..ops import gbuffer as gbuffer_ops
    from ..ops import texcache
    from ..pipeline import stages

    w, h = pipe.render_w, pipe.render_h
    buffers = pipe.buffers
    setup, vattrs, tri_id, _ = _frame_geometry(pipe, camera)
    tri_rows = stages.pack_rows64(setup, buffers, vattrs)
    interp, matrow, mask = gbuffer_ops.interp_from_rows(tri_id, tri_rows, w, h)
    tex, u, v, lod5, active = gbuffer_ops.tap_query(
        interp, matrow, mask, buffers["atlas"], use_tex_kernel=pipe.device.type == "cuda")
    return texcache.tap_census(buffers["atlas"], tex, u, v, lod5, active,
                               filter=pipe.texture_filter)


def env_census_for_pose(pipe, camera):
    """One frame's env-page-cache census: realized distinct-page demand of
    the exact tap groups the deferred pass builds (`shading.env_tap_groups`
    over the rendered G-buffer). Requires the pipeline's env cache
    (pipe.env_ids is not None)."""
    from ..ops import common, envcache, shading
    from ..pipeline import stages

    w, h = pipe.render_w, pipe.render_h
    cfg = pipe.config
    dev = pipe.device
    setup, vattrs, tri_id, depth = _frame_geometry(pipe, camera)
    gb = stages.gbuffer_shade(tri_id, depth, setup, pipe.buffers, vattrs, w, h,
                              texture_filter=pipe.texture_filter)
    normal = common.decode_octahedron(gb.normal_oct)
    _, _, _, n_dot_v, refl, ray = shading.pixel_view_geometry(
        gb.depth, normal, torch.as_tensor(np.asarray(camera.world_matrix(), np.float32),
                                          device=dev),
        torch.as_tensor(np.asarray(camera.position, np.float32), device=dev), w, h,
        cfg.fov, cfg.ratio, cfg.near, cfg.far, full_height=cfg.height, full_width=cfg.width)
    tex5, mip5, uq, vq, act, _fb, caps, *_ = shading.env_tap_groups(
        refl, ray, gb.rough_metal_ao[..., 0], n_dot_v, gb.mask, pipe.env_ids)
    th, tw = pipe.env_tile
    return envcache.tap_census(pipe.buffers["EnvCache"], tex5, mip5, uq, vq, act,
                               tile_h=th, tile_w=tw, caps=caps)


def run_census(pipe, camera, poses: int = 8, yaw_sweep_deg: float = 360.0,
               headroom: float = 1.5):
    """Census over a yaw sweep from the given start pose (the camera is
    rotated along it); returns (per-pose census list, recommended (cap_lo,
    cap_hi), per-pose env census list, empty without the env cache)."""
    from ..ops import texcache

    results, env_results = [], []
    step = yaw_sweep_deg / max(poses, 1) * np.pi / 180.0
    for i in range(poses):
        if i:
            camera.rotate(0.0, step, 0.0)
        results.append(census_for_pose(pipe, camera))
        if getattr(pipe, "env_ids", None) is not None:
            env_results.append(env_census_for_pose(pipe, camera))
    return results, texcache.recommend_caps(results, headroom=headroom), env_results


def main(argv=None):
    from ..app.app import DEFAULT_ASSET_ROOT, App, AppConfig
    from ..ops import envcache, texcache

    ap = argparse.ArgumentParser(
        prog="python -m direct12pbrrenderer_tpu_torch.tools.tap_census")
    ap.add_argument("--asset-root", default=DEFAULT_ASSET_ROOT)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--headroom", type=float, default=1.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)

    app = App(
        AppConfig(
            asset_root=args.asset_root,
            width=args.width,
            height=args.height,
            bin_cap=2048,
            tile_h=24,
            tile_w=128,
            device=args.device,
        )
    )
    censuses, caps, env_censuses = run_census(
        app.pipeline, app.camera, poses=args.poses, headroom=args.headroom
    )
    for i, c in enumerate(censuses):
        print(f"pose {i}: lo max={c['lo']['max']} p99={c['lo']['p99']} "
              f"mean={c['lo']['mean']:.1f} | hi max={c['hi']['max']} "
              f"p99={c['hi']['p99']} mean={c['hi']['mean']:.1f} | "
              f"tile_total max={c['tile_total']['max']} "
              f"p99={c['tile_total']['p99']} "
              f"mean={c['tile_total']['mean']:.0f}")
    for i, c in enumerate(env_censuses):
        print(f"env pose {i}: group max={c['group']['max']} "
              f"p99={c['group']['p99']} mean={c['group']['mean']:.1f} | "
              f"tile_total max={c['tile_total']['max']} "
              f"p99={c['tile_total']['p99']} "
              f"mean={c['tile_total']['mean']:.0f}")
    result = {
        "cap_lo": caps[0], "cap_hi": caps[1],
        "stage_budget": texcache.recommend_budget(censuses, headroom=args.headroom),
        "env_budget": envcache.recommend_budget(
            env_censuses, headroom=args.headroom
        ) if env_censuses else None,
        "headroom": args.headroom, "poses": args.poses,
        "width": args.width, "height": args.height,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
