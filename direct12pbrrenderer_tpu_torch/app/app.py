"""Application shell — counterpart of `app/app.py`: scene loading, frame
loop, camera scripting, stats.

The headless counterpart of `Engine/Source/App.cpp`: where the reference
opens a Win32 window, pumps WM_PAINT and drives a WASD fly camera
(App.cpp:117-152, 334-404), this app renders N frames to PNGs with an
optional scripted camera path, and reports the FPS + culling counters the
reference shows in its window title.

    python -m direct12pbrrenderer_tpu_torch.app --asset-root DIR [--out DIR]
    python -m direct12pbrrenderer_tpu_torch.app --asset-root DIR --device cpu

The same flags and defaults as the JAX package's App, plus `--device`
(default `cuda`). On the card the pipeline takes the fused kernel path
(kernels A-D) with the AppConfig knobs; without a card the default device
raises, and `--device cpu` renders through the kernels' plain versions.
There is no stand-in scene: a missing scene file raises. Each frame syncs
with `.cpu().numpy()` (the JAX package's `np.asarray`), and the PNGs are
written on the shared worker pool from that host copy.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..config import (
    DEFAULT_FAR,
    DEFAULT_FOV,
    DEFAULT_NEAR,
    RenderConfig,
)
from ..pipeline.deferred import DeferredRenderPipeline
from ..resource.loader import ResourceLoader
from ..scene.camera import Camera
from ..scene.scene import Scene
from ..utils.mathlib import Deg2Rad
from ..utils.threading import shared_pool

# the reference renderer's asset tree, where the JAX package's entry points
# look for it by default
DEFAULT_ASSET_ROOT = "/root/reference/DeferredRendering"


@dataclass
class AppConfig:
    asset_root: str = "."
    scene: str = "Asset/Scene/main.json"
    width: int = 1440
    height: int = 960
    frames: int = 60
    output_dir: str | None = None
    camera_pos: tuple = (0.0, 3.0, 10.0)
    camera_yaw_deg: float = 180.0
    camera_pitch_deg: float = 0.0
    orbit_deg_per_frame: float = 0.0  # scripted fly-around
    # the JAX package's tuned configuration (its app.py documents each
    # choice): tile 24x128, bin_cap 2048, census-sized texture caps with
    # per-half block caps (24, 12), the same-mip cover cascade, and the
    # (cap_small, hot_k) two-pass raster split (128, 64), whose hot-set
    # misses surface as bin_overflow
    tile_h: int = 24
    tile_w: int = 128
    bin_cap: int = 2048
    atlas_max_dim: int | None = 1024
    prefilter_size: int | None = None
    max_triangles: int = 65536
    max_vertices: int = 65536
    tex_caps: tuple | None = (92, 44, None, (24, 12))
    tex_cascade: tuple | bool = (12, 8, 0)
    env_budget: int | None = None
    raster_caps: tuple | None = (128, 64)
    device: str = "cuda"


class App:
    """Load -> frame loop (App::Run / InternalRun analog) on `cfg.device`."""

    def __init__(self, cfg: AppConfig):
        self.cfg = cfg
        device = torch.device(cfg.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {cfg.device}: torch.cuda.is_available() is false; "
                               "pass --device cpu for a run on the CPU")
        loader = ResourceLoader.set_instance(ResourceLoader(cfg.asset_root))
        self.scene = loader.load_resource(Scene, cfg.scene)

        render_cfg = RenderConfig(
            width=cfg.width,
            height=cfg.height,
            max_triangles=cfg.max_triangles,
            max_vertices=cfg.max_vertices,
            max_instances=max(len(self.scene.models), 1),
        )
        self.pipeline = DeferredRenderPipeline(
            self.scene,
            render_cfg,
            tile_h=cfg.tile_h,
            tile_w=cfg.tile_w,
            bin_cap=cfg.bin_cap,
            atlas_max_dim=cfg.atlas_max_dim,
            prefilter_size=cfg.prefilter_size,
            tex_caps=cfg.tex_caps,
            tex_cascade=cfg.tex_cascade,
            env_budget=cfg.env_budget,
            raster_caps=cfg.raster_caps,
            device=device,
        )
        # camera defaults match App::Initialize (App.cpp:99-101)
        self.camera = Camera(DEFAULT_FOV, cfg.width, cfg.height, DEFAULT_NEAR, DEFAULT_FAR)
        self.camera.move(cfg.camera_pos)
        self.camera.rotate(
            0.0, cfg.camera_yaw_deg * Deg2Rad, cfg.camera_pitch_deg * Deg2Rad
        )

    def run(self) -> dict:
        cfg = self.cfg
        out_dir = Path(cfg.output_dir) if cfg.output_dir else None
        if out_dir:
            out_dir.mkdir(parents=True, exist_ok=True)

        # warm-up frame: the kernels' first-use build and the first uploads
        t0 = time.perf_counter()
        self.pipeline.render(self.camera).cpu().numpy()
        compile_s = time.perf_counter() - t0

        frame_times = []
        writes = []
        for i in range(cfg.frames):
            if cfg.orbit_deg_per_frame:
                self.camera.rotate(0.0, cfg.orbit_deg_per_frame * Deg2Rad, 0.0)
            t0 = time.perf_counter()
            img = self.pipeline.render(self.camera, delta_time=1.0 / 60.0)
            img_np = img.cpu().numpy()  # sync
            frame_times.append(time.perf_counter() - t0)
            if out_dir:
                # PNG encodes ride the worker pool (TaskScheduler analog) so
                # disk IO never blocks the frame loop
                from PIL import Image

                path = out_dir / f"frame_{i:04d}.png"
                writes.append(
                    shared_pool().schedule(
                        lambda a=img_np, p=path: Image.fromarray(a).save(p)
                    )
                )

        for f in writes:
            f.result()
        times = np.asarray(frame_times)
        stats = self.pipeline.last_stats
        report = {
            "frames": cfg.frames,
            "resolution": f"{cfg.width}x{cfg.height}",
            "compile_s": round(compile_s, 3),
            "mean_frame_ms": round(float(times.mean()) * 1e3, 3),
            "p50_frame_ms": round(float(np.percentile(times, 50)) * 1e3, 3),
            "fps": round(1.0 / float(times.mean()), 2),
            "visible_instances": stats.visible_instances if stats else 0,
            "total_instances": stats.total_instances if stats else 0,
            "visible_lights": stats.visible_lights if stats else 0,
            "bin_overflow": stats.bin_overflow if stats else 0,
            "tex_approx_taps": getattr(stats, "tex_approx_taps", 0) if stats else 0,
        }
        return report


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m direct12pbrrenderer_tpu_torch.app",
        description="direct12pbrrenderer_tpu_torch — deferred PBR renderer on PyTorch/CUDA",
    )
    ap.add_argument("--asset-root", default=DEFAULT_ASSET_ROOT)
    ap.add_argument("--scene", default="Asset/Scene/main.json")
    ap.add_argument("--width", type=int, default=1440)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default=None, help="directory for PNG frames")
    ap.add_argument("--orbit", type=float, default=0.0, help="deg/frame camera orbit")
    ap.add_argument("--camera", type=float, nargs=3, default=(0.0, 3.0, 10.0))
    ap.add_argument("--yaw", type=float, default=180.0)
    ap.add_argument("--pitch", type=float, default=0.0)
    ap.add_argument("--bin-cap", type=int, default=2048)
    ap.add_argument("--tile", type=int, nargs=2, default=(24, 128))
    ap.add_argument("--tex-budget", type=int, default=None,
                    help="texture-cache staging page budget "
                         "(tools/tap_census.py sizes it)")
    ap.add_argument("--env-budget", type=int, default=None,
                    help="env-cache staging page budget")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="run the interactive browser viewer instead of "
                         "writing frames (WASD + right-drag fly camera)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)

    kw = {}
    if args.tex_budget:  # keep the tuned block_cap default, add the budget
        kw["tex_caps"] = (92, 44, args.tex_budget, (24, 12))
    app = App(
        AppConfig(
            asset_root=args.asset_root,
            scene=args.scene,
            width=args.width,
            height=args.height,
            frames=args.frames,
            output_dir=args.out,
            camera_pos=tuple(args.camera),
            camera_yaw_deg=args.yaw,
            camera_pitch_deg=args.pitch,
            orbit_deg_per_frame=args.orbit,
            tile_h=args.tile[0],
            tile_w=args.tile[1],
            bin_cap=args.bin_cap,
            env_budget=args.env_budget,
            device=args.device,
            **kw,
        )
    )
    if args.serve:
        from .viewer import serve

        serve(app, port=args.serve)
        return None
    report = app.run()
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
