"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `direct12pbrrenderer_tpu_torch/csrc`,
checks each against its plain PyTorch version on the card, then renders the
262,144-triangle stress scene with a procedural sky at 1920x1080 through the
port's main path and checks the frame against the same pipeline on its plain
path. Each phase prints one line; any failure exits non-zero. The last line
is `{"ok": true, "device": {...}}`. There is no CPU path: without a CUDA
device the script fails. It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
TILE_H, TILE_W, BIN_CAP = 24, 128, 8192
FRAMES, WARMUP = 16, 2
RMSE_BAR = 1e-3          # uint8/255 frame rmse, the JAX package's fidelity bar
ID_MISMATCH_BAR = 1e-4   # kernel-vs-plain winner disagreement (coverage ties)
INTERP_RTOL, INTERP_ATOL, Z_ATOL = 1e-3, 1e-4, 1e-4


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    say(phase, "FAIL " + msg)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs (CUDA events, after one warm-up)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(phase, kernel_out, plain_out) -> tuple[float, int]:
    """Hold the kernel's (tri_id, z, planes) against the plain version's with
    the CPU tests' bars; returns (max abs error over agreeing pixels, number
    of winner-id mismatches)."""
    ids_k, z_k, pl_k = (t.cpu().numpy() for t in kernel_out)
    ids_p, z_p, pl_p = (t.cpu().numpy() for t in plain_out)
    mismatch = ids_k != ids_p
    if mismatch.mean() >= ID_MISMATCH_BAR:
        fail(phase, f"{int(mismatch.sum())} winner-id mismatches of {mismatch.size}")
    agree = ~mismatch
    hits = agree & (ids_p >= 0)
    if not hits.any():
        fail(phase, "no covered pixels")
    interp_k, interp_p = pl_k[:8][:, agree], pl_p[:8][:, agree]
    mat_k, mat_p = pl_k[8:][:, agree], pl_p[8:][:, agree]
    if not np.array_equal(mat_k, mat_p):
        fail(phase, "material planes differ where winner ids agree")
    if not np.allclose(interp_k, interp_p, rtol=INTERP_RTOL, atol=INTERP_ATOL):
        fail(phase, f"interp planes differ: max {np.abs(interp_k - interp_p).max():.3e}")
    if not np.allclose(z_k[agree], z_p[agree], rtol=0.0, atol=Z_ATOL):
        fail(phase, f"z differs: max {np.abs(z_k[agree] - z_p[agree]).max():.3e}")
    if not (np.isfinite(pl_k).all() and np.isfinite(z_k).all()):
        fail(phase, "non-finite kernel output")
    return float(max(np.abs(pl_k[:, agree] - pl_p[:, agree]).max(initial=0.0),
                     np.abs(z_k[agree] - z_p[agree]).max(initial=0.0))), int(mismatch.sum())


def random_triangles(n: int, seed: int, device):
    """Random small triangles across ndc with w = 1 (the JAX package's raster
    test scene): (clip (3n, 4), tris (n, 3), payload (n, 40)), the payload a
    random material row and vertex-attribute rows (rows64 columns 16:56)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32)
    d = rng.uniform(-0.2, 0.2, (n, 2, 3)).astype(np.float32)
    v = np.concatenate([c, c + d], axis=1)
    v[..., 2] = rng.uniform(0.05, 0.95, (n, 3))
    verts = v.reshape(-1, 3)
    clip = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], axis=1)
    tris = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    rng = np.random.default_rng(seed + 100)
    payload = np.concatenate([rng.uniform(0, 1, (n, 16)), rng.uniform(-1, 1, (n, 24))],
                             1).astype(np.float32)
    t = torch.as_tensor
    return t(clip, device=device), t(tris, device=device), t(payload, device=device)


def procedural_sky(size: int, sun_dir, sun_intensity: float):
    """HDR sky cubemap (horizon gradient + sun disc) with SH baked on the
    host, as the console's CreateProceduralSky builds it."""
    from direct12pbrrenderer_tpu.resource.formats import ETextureFormat
    from direct12pbrrenderer_tpu.resource.resources import CubeMapResource
    from direct12pbrrenderer_tpu.resource.storage import CubeMapTextureData, TextureData
    from direct12pbrrenderer_tpu_torch.ops.common import cubemap_face_dirs

    dirs = cubemap_face_dirs(size)
    y = dirs[..., 1:2]
    horizon = np.array([0.35, 0.45, 0.65], np.float32)
    zenith = np.array([0.08, 0.18, 0.45], np.float32)
    ground = np.array([0.25, 0.22, 0.18], np.float32)
    t = np.clip(y, 0, 1) ** 0.6
    sky = horizon * (1 - t) + zenith * t
    sky = np.where(y < 0, ground * (1 + y), sky).astype(np.float32)
    sun = np.array(sun_dir, np.float32)
    sun /= np.linalg.norm(sun)
    cos = (dirs * sun).sum(-1, keepdims=True)
    sky = (sky + np.exp((cos - 1.0) * 800.0) * sun_intensity).astype(np.float32)
    faces = [
        TextureData.from_array(np.concatenate([sky[i], np.ones_like(sky[i][..., :1])], -1),
                               ETextureFormat.R32G32B32A32_FLOAT)
        for i in range(6)
    ]
    res = CubeMapResource("mem/sky")
    res.cubemap = CubeMapTextureData(faces=faces)
    return res


def frame_inputs(pipe, cam):
    """The GBuffer pass's geometry/binning/rows64 for one pose, outside the
    graph (for the kernel-vs-plain check at the main path's shapes), and the
    device ms of each of those stages."""
    from direct12pbrrenderer_tpu_torch.ops import common
    from direct12pbrrenderer_tpu_torch.pipeline import stages

    p, dev, cfg = pipe.packed, pipe.device, pipe.config
    mm = torch.as_tensor(p.model_mats, dtype=torch.float32, device=dev)
    nm = torch.as_tensor(np.ascontiguousarray(np.transpose(p.inv_model_mats[:, :3, :3],
                                                           (0, 2, 1))),
                         dtype=torch.float32, device=dev)
    planes = torch.as_tensor(np.asarray(cam.frustum_planes(), np.float32), device=dev)
    bounds = torch.as_tensor(p.instance_bounds, dtype=torch.float32, device=dev)
    vis = torch.zeros(mm.shape[0], dtype=torch.bool, device=dev)
    n = p.instance_count
    vis[:n] = common.frustum_cull_aabbs(planes, bounds[:n, 0], bounds[:n, 1])
    vp = torch.as_tensor(np.asarray(cam.projection_matrix() @ cam.view_matrix(), np.float32),
                         device=dev)

    def geometry():
        return stages.geometry(pipe.buffers, mm, nm, vis, vp, cfg.width, cfg.height)

    setup, vattrs = geometry()

    def binning():
        return stages.binning(setup, pipe.render_w, pipe.render_h, TILE_H, TILE_W, BIN_CAP)

    bins = binning()
    rows64 = stages.pack_rows64(setup, pipe.buffers, vattrs)
    ms = {"geometry": cuda_ms(geometry, 3), "binning": cuda_ms(binning, 3),
          "pack_rows64": cuda_ms(lambda: stages.pack_rows64(setup, pipe.buffers, vattrs), 3)}
    return setup, bins, rows64, ms


def timed_passes(pipe, cam, frames: int) -> dict[str, float]:
    """Mean device ms per graph pass (CUDA events around each pass)."""
    from direct12pbrrenderer_tpu.graph import frame_graph as fg

    graph = pipe.graph
    events: dict[str, list] = {}

    def wrap(pass_):
        def fn(env):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = pass_.fn(env)
            e.record()
            events.setdefault(pass_.name, []).append((s, e))
            return out
        return fg.RenderPass(pass_.name, pass_.reads, pass_.writes, fn, pass_.declares)

    pipe.graph = fg.CompiledGraph([wrap(p) for p in graph.order], graph.lifetimes,
                                  graph.donatable, graph.descriptions)
    try:
        for _ in range(frames):
            pipe.render(cam, 1.0 / 60.0, collect_stats=False)
        torch.cuda.synchronize()
    finally:
        pipe.graph = graph
    return {k: sum(s.elapsed_time(e) for s, e in v) / len(v) for k, v in events.items()}


def profiled_frames(pipe, cam, frames: int):
    """torch.profiler over `frames` frames: (wall ms per frame, device busy ms
    per frame, device activities per frame, [(ms per frame, kernel name)]
    of the top five). Busy time sums the device activities (kernels and
    copies run one at a time on the frame's single stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            pipe.render(cam, 1.0 / 60.0, collect_stats=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / frames
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(((v / 1e3 / frames, k) for k, v in by_name.items()), reverse=True)[:5]
    busy = sum(by_name.values()) / 1e3 / frames
    return wall, busy, len(events) / frames, top


def main() -> None:
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    from direct12pbrrenderer_tpu.config import RenderConfig
    from direct12pbrrenderer_tpu.scene.camera import Camera
    from direct12pbrrenderer_tpu.tools.stress_scene import build_stress_scene
    from direct12pbrrenderer_tpu_torch.kernels import build
    from direct12pbrrenderer_tpu_torch.ops import gbuffer, raster, raster_cuda
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    t0 = time.perf_counter()
    lib, log = build.build("raster_interp")
    ptxas = " ".join(l.strip() for l in log.splitlines() if "registers" in l or "spill" in l)
    say("build", f"raster_interp.cu -> {lib.name} in {time.perf_counter() - t0:.2f} s; "
        f"ptxas: {ptxas or 'reused build'}")

    # ---- kernel vs plain version, random triangles, two-pass split -------
    w, h, cap = 256, 192, 512
    clip, tris, payload = random_triangles(2500, 3, dev)
    setup = raster.setup_triangles(clip, tris, torch.ones(tris.shape[0], dtype=torch.bool,
                                                          device=dev), w, h)
    bins = raster.bin_triangles(setup, h // TILE_H, w // TILE_W, TILE_H, TILE_W, cap)
    rows64 = raster_cuda.pack_rows64(setup, payload)
    n_over = int((bins.counts > 128).sum())
    if n_over < 2:
        fail("kernel-random", f"scene does not exercise the two-pass split ({n_over})")
    caps = dict(cap_small=128, hot_k=max(1, n_over // 2))
    args = (setup, bins, rows64, w, h, TILE_H, TILE_W)
    err, nmis = compare("kernel-random", raster_cuda.rasterize_interp(*args, **caps),
                        raster_cuda.rasterize_interp_reference(*args, **caps))
    say("kernel-random", f"{w}x{h} 2500 tris cap {cap} cap_small 128 hot_k {caps['hot_k']} "
        f"of {n_over} overfull: ok, id mismatches {nmis}, max_abs_err {err:.3e}, kernel "
        f"{cuda_ms(lambda: raster_cuda.rasterize_interp(*args, **caps), 20):.4f} ms, plain "
        f"{cuda_ms(lambda: raster_cuda.rasterize_interp_reference(*args, **caps), 5):.4f} ms")

    # ---- scene + pipeline --------------------------------------------------
    t0 = time.perf_counter()
    scene = build_stress_scene(512, 256)
    scene.set_skybox(procedural_sky(256, (0.4, 0.6, 0.3), 80.0))
    cfg = RenderConfig(W, H, max_instances=2)
    knobs = dict(tile_h=TILE_H, tile_w=TILE_W, bin_cap=BIN_CAP, atlas_max_dim=256)
    pipe = DeferredRenderPipeline(scene, cfg, use_pallas=True, device=dev, **knobs)
    torch.cuda.synchronize()
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    say("scene", f"stress scene {pipe.packed.tris.shape[0]} tris, "
        f"{pipe.packed.light_count} lights, sky 256, precompute + pack "
        f"{time.perf_counter() - t0:.2f} s; use_pallas={pipe.use_pallas}")

    # ---- kernel vs plain version at the main path's shapes -----------------
    setup, bins, rows64, stage_ms = frame_inputs(pipe, cam)
    args = (setup, bins, rows64, pipe.render_w, pipe.render_h, TILE_H, TILE_W)
    err_full, nmis = compare("kernel-frame", raster_cuda.rasterize_interp(*args),
                             raster_cuda.rasterize_interp_reference(*args))
    ms = cuda_ms(lambda: raster_cuda.rasterize_interp(*args), 20)
    plain_ms = cuda_ms(lambda: raster_cuda.rasterize_interp_reference(*args), 3)
    # the same launch with every bin list cut to one chunk: what is left is
    # the output and the first chunk, so the difference is the longer lists
    one_chunk_ms = cuda_ms(lambda: raster_cuda.rasterize_interp(
        *args, cap_small=raster_cuda.CHUNK, hot_k=0), 20)
    counts = bins.counts.cpu().numpy()
    say("kernel-frame", f"{W}x{H} {rows64.shape[0]} tris, bin counts p50 "
        f"{np.percentile(counts, 50):.0f} p99 {np.percentile(counts, 99):.0f} max "
        f"{counts.max()}: ok, id mismatches {nmis}, max_abs_err {err_full:.3e}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; kernel with every list cut to "
        f"{raster_cuda.CHUNK} candidates {one_chunk_ms:.4f} ms")
    tri_id, depth, planes = raster_cuda.rasterize_interp(*args)
    stage_ms["gbuffer_shade_planar"] = cuda_ms(lambda: gbuffer.gbuffer_shade_planar(
        tri_id, depth, planes, pipe.buffers["atlas"]), 3)
    say("stages", "GBuffer pass stages, mean device ms (CUDA events): " + ", ".join(
        f"{k} {v:.2f}" for k, v in {**stage_ms, "rasterize_interp": ms}.items()))

    # ---- the main path: frames through the kernel --------------------------
    path, c = [], copy.deepcopy(cam)
    for _ in range(WARMUP + FRAMES):
        c = copy.deepcopy(c)
        c.rotate(0.0, 0.002, 0.0)
        path.append(c)
    for c in path[:WARMUP]:
        pipe.render(c)
    torch.cuda.synchronize()
    raster_cuda.rasterize_interp.launches = 0
    times = []
    for c in path[WARMUP:]:
        t0 = time.perf_counter()
        img = pipe.render(c, collect_stats=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = raster_cuda.rasterize_interp.launches
    if launches < FRAMES:
        fail("frame", f"kernel launched {launches} times in {FRAMES} frames")
    img = pipe.render(path[-1])  # stats of the last pose
    stats = pipe.last_stats
    rgb = img.cpu().numpy()
    lit = float((rgb.max(-1) > 16).mean())
    avg = float(pipe.avg_luminance)
    if rgb.shape != (H, W, 3) or not math.isfinite(avg) or avg <= 0 or lit < 0.05:
        fail("frame", f"bad frame: shape {rgb.shape}, avg luminance {avg}, lit {lit:.3f}")
    say("frame", f"{FRAMES} frames {W}x{H}: mean {np.mean(times):.2f} ms, p50 "
        f"{np.median(times):.2f} ms (host clock, synchronized per frame); kernel launches "
        f"{launches}; lit {lit:.3f}; avg luminance {avg:.5f} (finite); {stats}")

    per_pass = timed_passes(pipe, path[-1], 3)
    say("passes", "mean device ms per pass (CUDA events): " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_pass.items()))
    wall, busy, n_act, top = profiled_frames(pipe, path[-1], 3)
    if busy <= 0:
        fail("profile", "torch.profiler recorded no device time")
    say("profile", f"torch.profiler, 3 frames: wall {wall:.2f} ms/frame, device busy "
        f"{busy:.2f} ms/frame ({n_act:.0f} device activities), idle share "
        f"{1 - busy / wall:.3f}; top: " + "; ".join(f"{ms:.2f} ms {name[:60]}"
                                                    for ms, name in top))

    # ---- the same frame on the plain path ----------------------------------
    ref = DeferredRenderPipeline(scene, cfg, use_pallas=False, device=dev, **knobs)
    prev = pipe.avg_luminance.clone()
    ref.avg_luminance = prev.clone()
    a = pipe.render(path[-1], collect_stats=False).cpu().numpy().astype(np.float64)
    pipe.avg_luminance = prev
    b = ref.render(path[-1], collect_stats=False).cpu().numpy().astype(np.float64)
    rmse = float(np.sqrt(np.mean((a / 255.0 - b / 255.0) ** 2)))
    if rmse > RMSE_BAR:
        fail("fidelity", f"frame rmse vs use_pallas=False {rmse:.6f} > {RMSE_BAR}")
    say("fidelity", f"frame rmse vs use_pallas=False on the card {rmse:.6f} <= {RMSE_BAR}; "
        f"{int((a != b).any(-1).sum())} pixels differ")

    print(json.dumps({"kernels": [{
        "name": "raster_interp", "route": "cuda",
        "source": "direct12pbrrenderer_tpu_torch/csrc/raster_interp.cu",
        "replaces": "direct12pbrrenderer_tpu/ops/raster_pallas.py:157",
        "launches": launches, "max_abs_err": err_full, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
