"""Per-stage timing harness — counterpart of `tools/profile.py`, the
PIX-marker analog for the port's renderer.

The reference wraps every pass in PIXScopedEvent GPU markers
(DeferredPipeline.cpp:8 `PIXScope`, used throughout). `profile_pipeline`
runs each stage of `pipeline.stages` on its own, feeds it the
device-resident outputs of the previous stage, and times it over N
iterations: on a CUDA pipeline with CUDA events around each run (the
device's timeline, host gaps inside the stage included, as
`chip_smoke.py`'s `[stages]` times the GBuffer stages), on a CPU pipeline,
which the caller chooses, with the host clock. The JAX package times jitted
stages with a forced scalar readback instead.

Usage:
  python -m direct12pbrrenderer_tpu_torch.tools.profile \
      [--asset-root DIR] [--width W --height H] [--iters N] [--json FILE] [--device D]

Prints the per-stage table and one JSON line with the raw milliseconds.
`--no-env-kernel` drops the env page cache (`env_ids`) and, since kernel D
reads that cache, the fused deferred pass with it, then rebuilds the frame
graph (`_build_graph`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def time_stage(fn, device: torch.device, iters: int, warmup: int = 2) -> float:
    """Median ms per run of `fn()` after `warmup` runs: CUDA events around
    each run on a CUDA device, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            pairs = []
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                pairs.append((start, end))
            torch.cuda.synchronize()
        samples = [s.elapsed_time(e) for s, e in pairs]
    else:
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(samples))


def profile_pipeline(pipe, camera, iters: int = 5):
    """Per-stage timings (ms) for one frame configuration.

    Returns an ordered {stage: ms} dict: geometry, binning, raster,
    gbuffer_shade, light_cull, deferred_shade, bloom (when the config
    enables it), exposure_tonemap and full_frame (and full_frame_eager, the
    same frame inside `eager()`, where the pipeline is captured). Stage
    outputs are computed once (device-resident) and reused as the next
    stage's inputs, so each timing isolates that stage's cost exactly like
    a GPU pass marker would.
    """
    from ..ops import bloom as bloom_ops
    from ..ops import gbuffer as gbuffer_ops
    from ..ops import postprocess
    from ..pipeline import stages

    dev = pipe.device
    cfg = pipe.config
    w, h = cfg.width, cfg.height
    # the pipeline's pad-to-tile canvas: binning, raster, G-buffer and
    # shading run on it, geometry stays logical
    rw, rh = pipe.render_w, pipe.render_h
    p = pipe.packed
    planes = camera.frustum_planes()
    view = camera.view_matrix()
    buffers = pipe.buffers

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    model_mats = t(p.model_mats)
    normal_mats = t(np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1)))
    visible = t(p.instance_visibility(planes), torch.bool)
    light_valid = t(p.visible_lights(planes), torch.bool)
    view_t = t(np.asarray(view, np.float32))
    inv_view = t(np.asarray(camera.world_matrix(), np.float32))
    view_proj = t(np.asarray(camera.projection_matrix() @ view, np.float32))
    cam_pos = t(np.asarray(camera.position, np.float32))
    dt = torch.tensor(1.0 / 60.0, dtype=torch.float32, device=dev)
    prev_avg = torch.tensor(0.18, dtype=torch.float32, device=dev)

    timings: dict[str, float] = {}

    def run(name, fn):
        timings[name] = time_stage(fn, dev, iters)
        return fn()

    setup, vattrs = run("geometry", lambda: stages.geometry(
        buffers, model_mats, normal_mats, visible, view_proj, w, h))
    bins = run("binning", lambda: stages.binning(setup, rw, rh, pipe.tile_h, pipe.tile_w,
                                                 pipe.bin_cap))

    fused_def = pipe.use_fused_deferred
    if pipe.use_fused_gbuffer:
        # the pipeline's hot path: fused raster + interpolation (kernel A),
        # then the fused plan + resolve + shade (kernels B, C) on tile blocks
        tri_id, depth, pl_tiles, id_tiles, z_tiles = run("raster", lambda: (
            stages.rasterize_interp(setup, bins, buffers, vattrs, rw, rh, pipe.tile_h,
                                    pipe.tile_w, return_tiled=True,
                                    raster_caps=pipe.raster_caps, viewport=(w, h))))
        gb = run("gbuffer_shade", lambda: gbuffer_ops.gbuffer_shade_fused(
            tri_id, depth, pl_tiles, id_tiles, buffers["atlas"], rh, rw, pipe.tile_h,
            pipe.tile_w, pipe.texture_filter, tex_caps=pipe.tex_caps,
            tex_cascade=pipe.tex_cascade, return_tiled=fused_def))
        if fused_def:
            gb, gb_tiles = gb
    elif pipe.use_pallas:
        # fused raster + interpolation, then the planar G-buffer
        tri_id, depth, planes_ = run("raster", lambda: stages.rasterize_interp(
            setup, bins, buffers, vattrs, rw, rh, pipe.tile_h, pipe.tile_w,
            raster_caps=pipe.raster_caps, viewport=(w, h)))
        gb = run("gbuffer_shade", lambda: gbuffer_ops.gbuffer_shade_planar(
            tri_id, depth, planes_, buffers["atlas"], pipe.texture_filter,
            use_tex_kernel=pipe.use_tex_kernel, tex_caps=pipe.tex_caps,
            tex_cascade=pipe.tex_cascade))
    else:
        tri_id, depth = run("raster", lambda: stages.rasterize(
            setup, bins, rw, rh, pipe.tile_h, pipe.tile_w, pipe.use_pallas,
            raster_caps=pipe.raster_caps, viewport=(w, h)))
        gb = run("gbuffer_shade", lambda: stages.gbuffer_shade(
            tri_id, depth, setup, buffers, vattrs, rw, rh, texture_filter=pipe.texture_filter,
            use_tex_kernel=pipe.use_tex_kernel, tex_caps=pipe.tex_caps,
            tex_cascade=pipe.tex_cascade))

    active = run("light_cull", lambda: stages.active_lights(buffers, light_valid, view_t,
                                                            pipe.max_active_lights))

    if fused_def:
        # one fused kernel (D) from the G-buffer tile blocks to the HDR RT
        rt = run("deferred_shade", lambda: stages.deferred_shade_fused(
            gb_tiles, z_tiles, id_tiles, buffers, active, inv_view, cam_pos, cfg, rw, rh,
            pipe.tile_h, pipe.tile_w, pipe.env_ids, full_height=h, full_width=w,
            env_budget=pipe.env_budget)[0])
    else:
        rt = run("deferred_shade", lambda: stages.deferred_shade(
            gb, buffers, active, inv_view, cam_pos, cfg, rw, rh, full_height=h,
            full_width=w, env_ids=pipe.env_ids,
            env_tile=pipe.env_tile if pipe.env_ids is not None else None,
            env_budget=pipe.env_budget, light_tile=pipe.light_tile,
            light_cap=pipe.light_cap, light_count=pipe.packed.light_count))
        if isinstance(rt, tuple):
            rt = rt[0]
    rt = rt[:h, :w].contiguous()

    if cfg.enable_bloom:
        rt = run("bloom", lambda: bloom_ops.bloom(rt))

    def post():
        avg = postprocess.average_luminance_direct(rt, float(w * h), prev_avg, dt)
        out = postprocess.tone_map(rt, avg)
        return (out * 255.0 + 0.5).to(torch.uint8), avg

    run("exposure_tonemap", post)

    # whole-frame reconciliation: the frame the pipeline actually runs (a
    # replay of its CUDA graph where it is captured, and then also the same
    # frame run eagerly, stage by stage as above)
    n_frames = max(iters, 2)

    def frames():
        return [pipe.render(camera, collect_stats=False) for _ in range(n_frames)]

    timings["full_frame"] = time_stage(frames, dev, 1) / n_frames
    if pipe.captured:
        from ..pipeline.deferred import eager

        with eager():
            timings["full_frame_eager"] = time_stage(frames, dev, 1) / n_frames
    return timings


def main(argv=None):
    from ..app.app import DEFAULT_ASSET_ROOT

    ap = argparse.ArgumentParser(prog="python -m direct12pbrrenderer_tpu_torch.tools.profile")
    ap.add_argument("--asset-root", default=DEFAULT_ASSET_ROOT)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tile", type=int, nargs=2, default=(24, 128))
    ap.add_argument("--bin-cap", type=int, default=2048)
    ap.add_argument("--texture-filter", default="trilinear")
    ap.add_argument("--no-tex-kernel", action="store_true")
    ap.add_argument("--no-env-kernel", action="store_true")
    ap.add_argument("--json", default=None, help="also write timings to FILE")
    ap.add_argument(
        "--scene", default="reference", choices=["reference", "stress"],
        help="reference = the asset-tree scene; stress = the bench's "
             "Sponza-class 262k-triangle terrain at its exact bench config",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch.cuda.is_available() is false; "
                           "pass --device cpu for a run on the CPU")

    from ..pipeline.deferred import DeferredRenderPipeline

    if args.scene == "stress":
        # the bench's sponza_class cell, so the stage attribution explains it
        from ..config import RenderConfig
        from ..scene.camera import Camera
        from .stress_scene import build_stress_scene

        scene = build_stress_scene(cells_x=512, cells_y=256)
        cfg = RenderConfig(width=args.width, height=args.height, max_instances=2)
        pipe = DeferredRenderPipeline(
            scene, cfg, tile_h=args.tile[0], tile_w=args.tile[1],
            bin_cap=8192 if args.bin_cap == 2048 else args.bin_cap,
            atlas_max_dim=256, device=device,
        )
        camera = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
        camera.move([0, 6, 18])
        camera.rotate(0, np.pi, 0.35)
    else:
        from ..app.app import App, AppConfig

        app = App(AppConfig(
            asset_root=args.asset_root, width=args.width, height=args.height,
            tile_h=args.tile[0], tile_w=args.tile[1], bin_cap=args.bin_cap,
            device=args.device,
        ))
        if args.texture_filter != "trilinear" or args.no_tex_kernel:
            app.pipeline = DeferredRenderPipeline(
                app.scene, app.pipeline.config, tile_h=args.tile[0],
                tile_w=args.tile[1], bin_cap=args.bin_cap,
                texture_filter=args.texture_filter,
                use_tex_kernel=False if args.no_tex_kernel else None, device=device,
            )
        pipe, camera = app.pipeline, app.camera
    if args.no_env_kernel and pipe.env_ids is not None:
        pipe.env_ids = None
        pipe.use_fused_deferred = False
        pipe.graph = pipe._build_graph()

    t = profile_pipeline(pipe, camera, iters=args.iters)
    total = sum(v for k, v in t.items() if not k.startswith("full_frame"))
    print(f"\nPer-stage timings @ {args.width}x{args.height} on {device} "
          f"(tile {args.tile[0]}x{args.tile[1]}, bin_cap {args.bin_cap}, "
          f"{args.texture_filter}):\n")
    print(f"| {'stage':<18} | {'ms':>8} |")
    print("|--------------------|----------|")
    for k, v in t.items():
        if k == "full_frame":
            print("|--------------------|----------|")
        print(f"| {k:<18} | {v:8.1f} |")
    print(f"| {'(sum of stages)':<18} | {total:8.1f} |")
    print()
    print(json.dumps({"timings_ms": {k: round(v, 2) for k, v in t.items()}}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"timings_ms": t, "config": vars(args)}, f, indent=1)
    return t


if __name__ == "__main__":
    main()
