"""A/B measurement checklist — counterpart of `tools/tpu_checklist.py`.

Runs each pending measurement on one scene, loaded by the port's `App` from
an asset tree, and prints one JSON line per measurement, then the `ALL` line
with every result:

  1. frame_baseline   — fps of the App's pipeline (AppConfig knobs)
  2. stage_budget     — texture staging budgets full / 448 / 256 pages,
                        fps and the fallback taps each budget costs
  3. block_cap        — per-row cover capacity 16 / 12 / 8, fps and the
                        fallback taps
  4. tile_h           — opt-in (`--only tileh`): raster tile heights
                        16 / 24 / 32, fps and bin overflow
  5. env_census       — the env cache's per-tile page demand at the pose,
                        with the recommended budget, then env_budget full /
                        recommended / 48, fps and the env fallback taps
  6. rpc              — the frame split at `render`'s seam: the device frame
                        alone (`_frame` on resident scene and camera packs),
                        with the camera pack uploaded each frame, and the
                        whole `render()` (the host-side packing too)

The baseline and `rpc` time the App's own pipeline; every other check
takes fresh pipelines with the JAX tool's knobs (tile 24x128, bin_cap 2048).
`fps_of` enqueues the frames back to back and synchronizes once, by the
last frame's `.cpu()` copy. The JAX tool's `dyncover` check has no
counterpart: the port's kernel B has one form (README.md).

    python -m direct12pbrrenderer_tpu_torch.tools.checklist --asset-root DIR \
        [--width W --height H] [--frames N] [--only baseline,budget,...] [--device D]

On the card (the default device, `cuda`) the pipelines take the kernel
path; `--device cpu` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

CHECKS = ("baseline", "budget", "blockcap", "tileh", "envbudget", "rpc")
DEFAULT_CHECKS = ("baseline", "budget", "blockcap", "envbudget", "rpc")   # tileh opt-in


def fps_of(pipe, camera, frames: int = 6) -> float:
    """Frames per second of `frames` renders of `camera` after two warm
    ones, enqueued back to back, synchronized by the last frame's copy."""
    pipe.render(camera, collect_stats=False).cpu()
    pipe.render(camera, collect_stats=False).cpu()
    t0 = time.perf_counter()
    img = None
    for _ in range(frames):
        img = pipe.render(camera, 1.0 / 60.0, collect_stats=False)
    img.cpu()
    return frames / (time.perf_counter() - t0)


def rpc_split(pipe, camera, frames: int) -> dict[str, float]:
    """ms per frame of the device frame alone (`_frame` on the scene and
    camera packs resident on the device), of the same with the camera pack
    uploaded each frame, and of `render()` (packing, upload, frame)."""
    dev = pipe.device
    scene_dev = torch.as_tensor(pipe._pack_scene(), device=dev)
    cam_f32 = pipe._pack_camera(camera, 1.0 / 60.0)
    cam_dev = torch.as_tensor(cam_f32, device=dev)
    avg = pipe.avg_luminance
    pipe._frame(scene_dev, cam_dev, avg)[0].cpu()   # warm
    t0 = time.perf_counter()
    for _ in range(frames):
        out = pipe._frame(scene_dev, cam_dev, avg)
    out[0].cpu()
    exec_only = (time.perf_counter() - t0) / frames
    t0 = time.perf_counter()
    for _ in range(frames):
        out = pipe._frame(scene_dev, torch.as_tensor(cam_f32, device=dev), avg)
    out[0].cpu()
    with_upload = (time.perf_counter() - t0) / frames
    full = 1.0 / fps_of(pipe, camera, frames)
    return {"exec_only_ms": round(exec_only * 1e3, 3),
            "with_upload_ms": round(with_upload * 1e3, 3),
            "full_render_ms": round(full * 1e3, 3)}


def main(argv=None) -> dict:
    from ..app.app import DEFAULT_ASSET_ROOT, App, AppConfig

    ap = argparse.ArgumentParser(
        prog="python -m direct12pbrrenderer_tpu_torch.tools.checklist",
        description="one JSON line per A/B measurement on one scene")
    ap.add_argument("--asset-root", default=DEFAULT_ASSET_ROOT)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(CHECKS) + " (default: all but tileh)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)
    sel = set(args.only.split(",")) if args.only else set(DEFAULT_CHECKS)
    if sel - set(CHECKS):
        ap.error(f"unknown checks {sorted(sel - set(CHECKS))}; the checks are "
                 f"{', '.join(CHECKS)} (the JAX tool's dyncover has no counterpart: "
                 "kernel B has one form in the port)")
    scene_file = Path(args.asset_root) / AppConfig.scene
    if not scene_file.is_file():
        ap.error(f"no scene at {scene_file}: --asset-root must name an asset tree "
                 "(python -m direct12pbrrenderer_tpu_torch.app.console builds one)")

    from ..ops import envcache
    from ..pipeline.deferred import DeferredRenderPipeline
    from .tap_census import env_census_for_pose

    app = App(AppConfig(asset_root=args.asset_root, width=args.width, height=args.height,
                        tile_h=24, tile_w=128, bin_cap=2048, device=args.device))
    scene, cam, cfg = app.scene, app.camera, app.pipeline.config
    dev = app.pipeline.device

    def mk(**kw):
        return DeferredRenderPipeline(scene, cfg, tile_h=24, tile_w=128, bin_cap=2048,
                                      device=dev, **kw)

    results = {}

    def report(key, result):
        results[key] = result
        print(json.dumps({"check": key, **result}), flush=True)

    def sweep(key, pipe, stat):
        fps = round(fps_of(pipe, cam, args.frames), 3)
        pipe.render(cam, collect_stats=True).cpu()
        report(key, {"fps": fps, stat: int(getattr(pipe.last_stats, stat))})

    if "baseline" in sel:
        report("frame_baseline", {"fps": round(fps_of(app.pipeline, cam, args.frames), 3)})

    if "budget" in sel:
        for budget in (None, 448, 256):
            sweep(f"stage_budget_{budget or 'full'}",
                  mk(tex_caps=None if budget is None else (92, 44, budget)), "tex_approx_taps")

    if "blockcap" in sel:
        for bc in (16, 12, 8):
            sweep(f"block_cap_{bc}", mk(tex_caps=(92, 44, None, bc)), "tex_approx_taps")

    if "tileh" in sel:
        for th in (16, 24, 32):
            sweep(f"tile_h_{th}", DeferredRenderPipeline(
                scene, cfg, tile_h=th, tile_w=128, bin_cap=2048, env_budget=136,
                tex_caps=(92, 44, None, 12), device=dev), "bin_overflow")

    if "envbudget" in sel and app.pipeline.env_ids is not None:
        census = env_census_for_pose(app.pipeline, cam)
        rec = envcache.recommend_budget([census])
        report("env_census", {**census, "recommended": rec})
        for budget in (None, rec, 48):
            sweep(f"env_budget_{budget or 'full'}", mk(env_budget=budget), "env_approx_taps")

    if "rpc" in sel:
        report("rpc", rpc_split(app.pipeline, cam, args.frames))

    print(json.dumps({"check": "ALL", "results": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
