"""The port's bench: deferred PBR frames per second on one GPU, with a
binding fidelity gate on every cell — the counterpart of the repo's
`bench.py`, under its JSON keys.

    python -m direct12pbrrenderer_tpu_torch.bench                # on the card
    python -m direct12pbrrenderer_tpu_torch.bench --smoke --device cpu

Prints ONE JSON line. Its cells, each rendered through
`DeferredRenderPipeline.render` on `--device` (default `cuda`; without a
card that raises: the bench never carries on on the CPU):

* `--smoke`: the one-sphere scene of `tools/tiny_scene` at 128x96, tile 12x64
  (`__graft_entry__._tiny_pipeline`'s scene, knobs and camera);
* `sponza_class`, the headline: `build_stress_scene(512, 256)` (262,144
  triangles) at --width x --height, `RenderConfig(max_instances=2)`, tile
  24x128, bin_cap 8192, atlas_max_dim 256, every other knob at its default;
* `lights1k` (left out by --skip-secondary): `build_stress_scene(128, 64,
  n_lights=1024)`, max_lights and max_active_lights 1024, bin_cap 2048,
  atlas_max_dim 256.

Both stress cells look from (0, 6, 18) at yaw pi, pitch 0.35.

The reference scene, `bench.py`'s own headline: with `--asset-root` (default
the reference asset tree, `app.DEFAULT_ASSET_ROOT`) holding the App's default scene
(`Asset/Scene/main.json`), the port's `App` at the AppConfig defaults and
`--width` x `--height` (tile 24x128, bin_cap 2048, census-sized texture
caps (92, 44, None, (24, 12)), the cascade (12, 8, 0), raster caps (128,
64), atlas 1024) is the first cell and the headline, at the App's camera;
with `--texture-filter` other than trilinear its pipeline is rebuilt with
that filter and every other knob at its default, as `bench.py` does. The
stress cells follow as secondary cells, and `--skip-secondary` leaves them
out. Without the scene, sponza_class is the headline and the reference scene
reads "not measured" with the path it looked for; nothing stands in for it.

fps: two warm frames of a yaw path (0.002 rad a frame), then `--frames`
frames on the host clock, with one `torch.cuda.synchronize()` after the last
inside the timed window (`headline_method` "loop"; the port's
`render_sequence` is the same loop, so there is no sequence fps).

`rmse_vs_xla` keeps `bench.py`'s name so that the two lines line up. Here it
is the frame rmse (uint8/255, in float64) against a pipeline with
`use_pallas=False, use_tex_kernel=False` on the same device, built with the
benched pipeline's content knobs (atlas_max_dim, brdf_lut_size,
prefilter_size, tile, bin_cap, max_active_lights, texture_filter and config)
and started from its exposure carry. The gate binds on every cell: a cell
whose rmse exceeds 1e-3 moves its fps and rmse to its `tuned` keys and is
measured again on the gate-safe configuration (`tex_caps=None,
use_tex_kernel=False, env_budget=None`, the raster kernel kept at its default
two-pass caps, as `bench.py` re-measures), reported as
`fidelity_fallback: "xla-samplers"`, with its FrameStats counters collected
anew. A gate that still fails reads "FAIL", and the command exits non-zero.
Nothing is caught: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .app.app import DEFAULT_ASSET_ROOT, App, AppConfig
from .config import RenderConfig
from .pipeline.deferred import DeferredRenderPipeline
from .resource.loader import ResourceLoader
from .scene.camera import Camera
from .tools.stress_scene import build_stress_scene
from .tools.tiny_scene import tiny_pipeline

# A 60 Hz real-time frame rate at 1920x1080: what vs_baseline divides by.
BASELINE_FPS = 60.0
RMSE_BAR = 1e-3   # uint8/255 frame rmse against the all-plain pipeline
SMOKE_FRAMES = 4
# the FrameStats counters a cell reports, collected anew after a fallback
STAT_KEYS = ("tex_approx_taps", "env_approx_taps", "bin_overflow", "visible_lights",
             "light_tile_overflow")
# the headline's keys (bench.py's names) <- the headline cell's keys
HEADLINE_KEYS = {"rmse_vs_xla": "rmse", "rmse_gate": "rmse_gate",
                 "tex_approx_taps": "tex_approx_taps", "env_approx_taps": "env_approx_taps",
                 "bin_overflow": "bin_overflow", "tuned_fps": "tuned_fps",
                 "tuned_rmse_vs_xla": "tuned_rmse", "fidelity_fallback": "fidelity_fallback"}
CELL_KEYS = ("fps", "rmse", "rmse_gate", "tuned_fps", "tuned_rmse", "fidelity_fallback",
             "bin_overflow", "tex_approx_taps", "env_approx_taps")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m direct12pbrrenderer_tpu_torch.bench")
    ap.add_argument("--frames", type=int, default=None,
                    help=f"timed frames per cell (default 32; {SMOKE_FRAMES} with --smoke)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny synthetic scene + small frame (CI / CPU smoke run)")
    ap.add_argument("--asset-root", default=DEFAULT_ASSET_ROOT,
                    help="asset tree of the reference-scene cell (the App's default scene)")
    ap.add_argument("--texture-filter", default="trilinear",
                    choices=["trilinear", "bilinear", "anisotropic"],
                    help="the reference-scene cell's texture filter")
    ap.add_argument("--skip-secondary", action="store_true",
                    help="the headline cell only (skip the secondary stress cells)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch.cuda.is_available() is false; "
                           "pass --device cpu for a run on the CPU")

    if args.smoke:
        frames = args.frames or SMOKE_FRAMES
        pipe, cam, cfg = tiny_pipeline(device)
        result = _headline(_measure_cell(pipe, cam, frames), "",
                           f"synthetic sphere scene @ {cfg.width}x{cfg.height}")
        result["vs_baseline_scene"] = "synthetic_sphere"
        result["reference_scene_vs_baseline"] = None
        result["reference_scene"] = "not measured: --smoke"
    else:
        frames = args.frames or 32
        scene_file = ResourceLoader(args.asset_root).resolve(AppConfig.scene, ".json")
        has_reference = scene_file.exists()
        if has_reference:
            result = _headline(_reference_bench(args, frames), "",
                               f"reference scene @ {args.width}x{args.height}")
            result.update(reference_scene_vs_baseline=result["vs_baseline"],
                          reference_scene=str(scene_file), vs_baseline_scene="reference_scene")
        if not (has_reference and args.skip_secondary):
            sponza = _stress_bench(args, frames)
            if not has_reference:
                result = _headline(
                    sponza, "sponza_class_",
                    f"Sponza-class stress scene ({sponza['sponza_class_triangles']:,} "
                    f"triangles) @ {args.width}x{args.height}")
                result.update(reference_scene_vs_baseline=None,
                              reference_scene=f"not measured: no scene at {scene_file}")
            result.update(sponza)
            # vs_baseline against the scene the baseline names, as bench.py
            # computes it; the reference scene's ratio stays beside it
            result["vs_baseline"] = sponza["sponza_class_fps"] / BASELINE_FPS
            result["vs_baseline_scene"] = "sponza_class"
            if not args.skip_secondary:
                result.update(_lights1k_bench(args, frames))
    result["device"] = _device_label(device)
    print(json.dumps(result))
    return result


def failed_gates(result: dict) -> list[str]:
    """The gates of `result` that still fail after their re-measure."""
    return [k for k, v in result.items() if k.endswith("rmse_gate") and v == "FAIL"]


def _headline(cell: dict, prefix: str, scene_name: str) -> dict:
    fps = cell[prefix + "fps"]
    result = {
        "metric": f"deferred PBR frame rate, {scene_name}",
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / BASELINE_FPS,
        "per_call_loop_fps": fps,
        "headline_method": "loop",
    }
    result.update({k: cell[prefix + c] for k, c in HEADLINE_KEYS.items() if prefix + c in cell})
    return result


def _device_label(device: torch.device) -> str:
    """The card's nvidia-smi name and power limit, or the device type. The
    card is named by its UUID: nvidia-smi's order of the cards need not be
    CUDA's."""
    if device.type != "cuda":
        return device.type
    uuid = torch.cuda.get_device_properties(device).uuid
    return subprocess.run(["nvidia-smi", "-i", f"GPU-{uuid}", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure_fps(pipe, cam, frames: int) -> float:
    """Per-call loop fps over the yaw path: every frame re-culls, re-bins and
    re-plans its caches. Frames are enqueued back to back; the one sync
    after the last is inside the timed window."""
    cams = _yaw_path(cam, frames)
    for c in cams[:2]:   # kernel builds, staging buffers, the first uploads
        pipe.render(c, 1.0 / 60.0, collect_stats=False)
    _sync(pipe.device)
    t0 = time.perf_counter()
    for c in cams:
        pipe.render(c, 1.0 / 60.0, collect_stats=False)
    _sync(pipe.device)
    return frames / (time.perf_counter() - t0)


def _frame_stats(pipe, cam) -> dict:
    """The FrameStats counters of one frame at the bench pose."""
    pipe.render(cam, 1.0 / 60.0, collect_stats=True)
    return {k: int(getattr(pipe.last_stats, k)) for k in STAT_KEYS}


def _rmse_vs_plain(pipe, cam) -> float:
    """One-pose rmse of `pipe` against the all-plain pipeline
    (`use_pallas=False, use_tex_kernel=False`) with the same content knobs,
    on the normalized uint8 back buffer; both frames start from a clone of
    `pipe`'s exposure carry."""
    ref = DeferredRenderPipeline(
        pipe.scene, pipe.config, tex_caps=None, env_budget=None, use_tex_kernel=False,
        use_pallas=False, texture_filter=pipe.texture_filter, tile_h=pipe.tile_h,
        tile_w=pipe.tile_w, bin_cap=pipe.bin_cap, max_active_lights=pipe.max_active_lights,
        atlas_max_dim=pipe.atlas_max_dim, brdf_lut_size=pipe.brdf_lut_size,
        prefilter_size=pipe.prefilter_size, device=pipe.device)
    prev = pipe.avg_luminance
    ref.avg_luminance = prev.clone()
    a = pipe.render(cam, 1.0 / 60.0, collect_stats=False).cpu().numpy()
    pipe.avg_luminance = prev.clone()
    b = ref.render(cam, 1.0 / 60.0, collect_stats=False).cpu().numpy()
    return float(np.sqrt(np.mean(
        (a.astype(np.float64) / 255.0 - b.astype(np.float64) / 255.0) ** 2)))


def _fidelity_gate(pipe, cam, tol: float = RMSE_BAR) -> tuple[float, str]:
    """(rmse against the all-plain pipeline, "pass" or "FAIL" at `tol`)."""
    rmse = _rmse_vs_plain(pipe, cam)
    if rmse > tol:
        print(f"bench: fidelity gate failed, rmse {rmse:.6f} > {tol}", file=sys.stderr)
    return rmse, "pass" if rmse <= tol else "FAIL"


def _gate_safe_pipeline(pipe) -> DeferredRenderPipeline:
    """`pipe`'s scene and knobs with the texture and env taps through the
    plain samplers (`tex_caps=None, use_tex_kernel=False, env_budget=None`);
    the raster kernel, and the tiled lights where `pipe` has them, stay.
    The raster's two-pass split takes its default caps, as in `bench.py`'s
    re-measure (the reference cell's tuned `raster_caps` are left out)."""
    return DeferredRenderPipeline(
        pipe.scene, pipe.config, tile_h=pipe.tile_h, tile_w=pipe.tile_w,
        bin_cap=pipe.bin_cap, atlas_max_dim=pipe.atlas_max_dim,
        prefilter_size=pipe.prefilter_size, brdf_lut_size=pipe.brdf_lut_size,
        use_pallas=pipe.use_pallas, use_tex_kernel=False,
        texture_filter=pipe.texture_filter, max_active_lights=pipe.max_active_lights,
        tex_caps=None, env_budget=None, device=pipe.device)


def _measure_cell(pipe, cam, frames: int) -> dict:
    """fps, FrameStats counters and the fidelity gate of one cell, bound: a
    failing gate re-measures everything on the gate-safe configuration."""
    out = {"fps": _measure_fps(pipe, cam, frames), **_frame_stats(pipe, cam)}
    out["rmse"], out["rmse_gate"] = _fidelity_gate(pipe, cam)
    if out["rmse_gate"] == "FAIL":
        print("bench: re-measuring on the gate-safe configuration", file=sys.stderr)
        out["tuned_fps"], out["tuned_rmse"] = out.pop("fps"), out.pop("rmse")
        for k in STAT_KEYS:   # the tuned run's counters do not describe the new one
            del out[k]
        pipe = _gate_safe_pipeline(pipe)
        out["fps"] = _measure_fps(pipe, cam, frames)
        out.update(_frame_stats(pipe, cam))
        out["rmse"], out["rmse_gate"] = _fidelity_gate(pipe, cam)
        out["fidelity_fallback"] = "xla-samplers"
    return out


def _yaw_path(cam, n: int):
    """n-frame camera path: tiny yaw steps around the bench pose (a real
    animation — every frame re-culls, re-bins, re-plans its caches)."""
    cams = []
    c = copy.deepcopy(cam)
    for _ in range(n):
        c = copy.deepcopy(c)
        c.rotate(0.0, 0.002, 0.0)
        cams.append(c)
    return cams


def _bench_camera(cfg: RenderConfig) -> Camera:
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, np.pi, 0.35)
    return cam


def _reference_bench(args, frames: int = 32) -> dict:
    """The reference scene through the port's App at the AppConfig defaults
    and --width x --height, at the App's camera: the cell's fps, counters
    and gate (`_measure_cell`)."""
    app = App(AppConfig(asset_root=args.asset_root, width=args.width, height=args.height,
                        frames=frames, device=args.device))
    pipe = app.pipeline
    if args.texture_filter != "trilinear":
        pipe = DeferredRenderPipeline(app.scene, pipe.config,
                                      texture_filter=args.texture_filter, device=args.device)
    return _measure_cell(pipe, app.camera, frames)


def _stress_bench(args, frames: int = 32, cells: tuple[int, int] = (512, 256)) -> dict:
    """The Sponza-class density: a 262,144-triangle terrain at
    --width x --height."""
    scene = build_stress_scene(cells_x=cells[0], cells_y=cells[1])
    cfg = RenderConfig(width=args.width, height=args.height, max_instances=2)
    pipe = DeferredRenderPipeline(scene, cfg, tile_h=24, tile_w=128, bin_cap=8192,
                                  atlas_max_dim=256, device=args.device)
    cell = _measure_cell(pipe, _bench_camera(cfg), frames)
    out = {"sponza_class_triangles": cells[0] * cells[1] * 2}
    out.update({f"sponza_class_{k}": cell[k] for k in CELL_KEYS if k in cell})
    return out


def _lights1k_bench(args, frames: int = 32, cells: tuple[int, int] = (128, 64)) -> dict:
    """1024 scattered point lights: the reference's clustered-shading
    capacity, through the tile-clustered lights (kernel G) on the card."""
    scene = build_stress_scene(cells_x=cells[0], cells_y=cells[1], n_lights=1024)
    cfg = RenderConfig(width=args.width, height=args.height, max_instances=2,
                       max_lights=1024)
    pipe = DeferredRenderPipeline(scene, cfg, tile_h=24, tile_w=128, bin_cap=2048,
                                  atlas_max_dim=256, max_active_lights=1024,
                                  device=args.device)
    cell = _measure_cell(pipe, _bench_camera(cfg), frames)
    out = {"lights1k_visible": cell["visible_lights"],
           "lights1k_tile_overflow": cell["light_tile_overflow"]}
    out.update({f"lights1k_{k}": cell[k] for k in CELL_KEYS if k in cell})
    return out


if __name__ == "__main__":
    sys.exit(1 if failed_gates(main()) else 0)
