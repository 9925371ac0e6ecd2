"""Per-stage timing harness — counterpart of `tools/profile.py`, the
PIX-marker analog for the port's renderer.

The reference wraps every pass in PIXScopedEvent GPU markers
(DeferredPipeline.cpp:8 `PIXScope`, used throughout). `profile_pipeline`
renders the frame the pipeline runs (on a card the captured frame, on the
CPU the eager one) with the frame tracer on (`utils/trace.py`) and reads
each stage from its spans: the device marks at every pass and GBuffer
stage, on the device's timeline on a card and on the host clock on the
CPU. The JAX package times jitted stages with a forced scalar readback
instead.

Usage:
  python -m direct12pbrrenderer_tpu_torch.tools.profile \
      [--asset-root DIR] [--width W --height H] [--iters N] [--json FILE] [--device D] \
      [--trace FILE]

Prints the per-stage table and one JSON line with the raw milliseconds;
`--trace FILE` writes the traced frames as a Chrome trace (host and device
spans on one clock; open it in Perfetto). `--no-env-kernel` drops the env
page cache (`env_ids`) and, since kernel D reads that cache, the fused
deferred pass with it, then rebuilds the frame graph (`_build_graph`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# each stage of the JAX profile and the spans it sums (`utils/trace.py`)
STAGES = (
    ("geometry", ("gbuffer.geometry",)),
    ("binning", ("gbuffer.binning",)),
    ("raster", ("gbuffer.raster",)),
    ("gbuffer_shade", ("gbuffer.tex_plan", "gbuffer.tex_resolve")),
    ("light_cull", ("Clustered",)),
    ("deferred_shade", ("DeferredShading", "Skybox")),
    ("bloom", ("Bloom",)),
    ("exposure_tonemap", ("AutoExposure", "ToneMapping", "Present")),
)


def time_stage(fn, device: torch.device, iters: int, warmup: int = 2) -> float:
    """Median ms per run of `fn()` after `warmup` runs: CUDA events around
    each run on a CUDA device, the host clock on the CPU (the JAX package's
    `time_stage`; `profile_pipeline` reads the frame's spans instead)."""
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


def traced_frames(pipe, camera, frames: int):
    """A `Trace` of `frames` frames rendered as the caller would, after the
    recapture that turning tracing on makes (and its warm-up frames)."""
    pipe.start_trace(ring_frames=frames + 8)
    for _ in range(frames):
        pipe.render(camera, collect_stats=False)
    return pipe.stop_trace()


def profile_pipeline(pipe, camera, iters: int = 5, chrome: str | None = None):
    """Per-stage timings (ms a frame, the mean over `iters` traced frames)
    for one frame configuration.

    Returns an ordered {stage: ms} dict: geometry, binning, raster,
    gbuffer_shade (texture plan and resolve), light_cull (Clustered),
    deferred_shade (DeferredShading and Skybox), bloom (when the config
    enables it), exposure_tonemap (AutoExposure, ToneMapping, Present),
    full_frame (the frame's first mark to its last) and, where the pipeline
    is captured, full_frame_eager (the same frame inside `eager()`). With
    `chrome`, the captured frames' trace is written there as a Chrome trace.
    """
    from ..pipeline.deferred import eager

    n = max(iters, 2)
    pipe.render(camera, collect_stats=False)   # the first render's census and capture
    tr = traced_frames(pipe, camera, n)
    dev = tr.summary()["device"]
    timings = {stage: sum(dev.get(s, 0.0) for s in spans) for stage, spans in STAGES
               if stage != "bloom" or pipe.config.enable_bloom}
    timings["full_frame"] = dev["frame"]
    if pipe.captured:
        with eager():
            timings["full_frame_eager"] = traced_frames(pipe, camera, n).summary()["device"][
                "frame"]
    if chrome:
        tr.export_chrome(chrome)
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
    ap.add_argument("--trace", default=None,
                    help="also write the traced frames to FILE as a Chrome trace (Perfetto)")
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

    t = profile_pipeline(pipe, camera, iters=args.iters, chrome=args.trace)
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
