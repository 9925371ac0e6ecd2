"""Kernel G (csrc/point_lights.cu) against its plain PyTorch version on a
CUDA device, and a 256x96 frame of the 1024-light path (72 lights,
`max_active_lights=128`: kernels A, B, C, F and G) on the card against the
same pipeline on the CPU. Needs the card: marked `cuda`, skipped elsewhere
(`python -m pytest --noconftest tests/test_torch_*_cuda.py` on a GPU machine
without JAX).

The kernel is held to chip_smoke's bar: hit counters equal on all but 1e-4
of the pixels (a one-ulp difference in log or pow at a cluster slice edge
can flip a membership; at most one pixel at these sizes), rgb within rtol
1e-4 / atol 1e-5 on the masked pixels whose counters agree. The cases of its
per-cluster lists: warps spanning many clusters and slices, clusters with
exactly 31, 32 and 33 hits, admitted lights at list positions 127, 128 and
129 (a chunk flush between them), a full 1024-entry list, every pixel
masked, and a 64x48 frame whose two tiles span hundreds of clusters each.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import recording
from direct12pbrrenderer_tpu_torch.config import CLUSTER_X, CLUSTER_Y
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import lights_cuda

pytestmark = pytest.mark.cuda
H, W, TILE = 96, 256, (24, 128)
FOV, NEAR, FAR = math.pi / 3.0, 0.1, 100.0


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(seed, n, pool, covering):
    """A random G-buffer and `n` of `pool` light rows inside the frustum
    (identity view): (rows, albedo, normal, roughness, metallic, z_view,
    mask) as CPU tensors."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 60.0, n)
    th = math.tan(FOV / 2.0)
    pos = np.stack([rng.uniform(-1, 1, n) * z * th * W / H, rng.uniform(-1, 1, n) * z * th, z],
                   -1)
    cull = np.full(n, 500.0) if covering else rng.uniform(2.0, 15.0, n)
    rows = np.concatenate([pos, rng.uniform(0.2, 1.0, (n, 3)), rng.uniform(1, 8, (n, 1)),
                           np.tile([1.0, 0.1, 0.01], (n, 1)), pos, cull[:, None]], 1)
    rows = np.pad(rows, ((0, pool - n), (0, 0))).astype(np.float32)
    nrm = rng.normal(size=(H, W, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    depth = rng.uniform(0.05, 0.95, (H, W))
    z_view = NEAR * FAR / (FAR - depth * (FAR - NEAR))
    t = torch.as_tensor
    return (t(rows), t(rng.uniform(0.05, 1.0, (H, W, 3)).astype(np.float32)),
            t(nrm.astype(np.float32)), t(rng.uniform(0.05, 1.0, (H, W)).astype(np.float32)),
            t(rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)), t(z_view.astype(np.float32)),
            t(rng.uniform(0, 1, (H, W)) > 0.1))


def _check_kernel(kargs, kw):
    """Kernel G against its plain version on the same inputs, at the bar of
    the module docstring. -> (kernel output, plain output) as numpy."""
    before = LAUNCHES["point_lights"]
    got = lights_cuda.point_lights_kernel(*kargs, **kw)
    assert LAUNCHES["point_lights"] == before + 1
    want = lights_cuda.point_lights_kernel_reference(*kargs, **kw)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got).all()
    same = got[..., 3] == want[..., 3]
    assert (~same).sum() <= max(1, 1e-4 * same.size)
    masked = same & (kargs[3][..., 9].cpu().numpy() > 0.5)
    np.testing.assert_allclose(got[..., :3][masked], want[..., :3][masked], rtol=1e-4,
                               atol=1e-5)
    return got, want


@pytest.mark.parametrize("seed,n,pool,covering", [
    (7, 130, 256, False),      # scattered: tens of lights per tile
    (8, 64, 128, True),        # every cluster reaches the cap of 32
    (9, 1000, 1024, False),    # lists above 128: several staged chunks per tile
])
def test_kernel_matches_plain_version(device, seed, n, pool, covering):
    rows, *gb = _inputs(seed, n, pool, covering)
    args = [x.to(device) for x in (rows, *gb)]
    with recording(lights_cuda, "point_lights_kernel") as calls:
        _, counts = lights_cuda.point_lights_tiled(
            args[0], *args[1:], torch.eye(4, device=device), torch.zeros(3, device=device),
            FOV, W / H, NEAR, FAR, W, H, tile_h=TILE[0], tile_w=TILE[1], cap=pool)
    (kargs, kw), = calls
    _, want = _check_kernel(kargs, kw)
    if n > 500:
        assert int(counts.max()) > 128
    if covering:
        assert (want[..., 3] == 32).any()
    # the warps span several clusters and slices (random depth per pixel)
    keys = lights_cuda.pixel_cluster_keys(kargs[1], kargs[3], **kw)
    per_warp = [torch.unique(w).numel() for w in keys.reshape(-1, 32)]
    assert max(per_warp) >= 8
    slices = keys // (CLUSTER_X * CLUSTER_Y)
    assert max(torch.unique(w).numel() for w in slices.reshape(-1, 32)) >= 4


def _uniform_inputs(device, light_rows, count, *, cap, depth=0.5, masked=True, h=H, w=W,
                    tile=TILE):
    """Kernel G's inputs with a G-buffer of one depth (each tile holds a few
    clusters) and the staged light rows `light_rows` (count, 14) listed at
    positions 0..count-1 of every tile."""
    rng = np.random.default_rng(3)
    nrm = rng.normal(size=(h, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    z_view = np.full((h, w), NEAR * FAR / (FAR - depth * (FAR - NEAR)))
    t = lambda x, dt=np.float32: torch.as_tensor(np.asarray(x).astype(dt), device=device)  # noqa
    gb_t = lights_cuda.tile_gbuffer(
        t(rng.uniform(0.05, 1.0, (h, w, 3))), t(nrm), t(rng.uniform(0.05, 1.0, (h, w))),
        t(rng.uniform(0.0, 1.0, (h, w))), t(z_view), t(np.full((h, w), masked), bool), *tile)
    tiles = gb_t.shape[0]
    rows_t = torch.zeros((tiles, lights_cuda.ROW_LEN, cap), device=device)
    rows_t[:, :14, :count] = t(light_rows).T[None]
    const = lights_cuda.light_constants(torch.eye(4, device=device), torch.zeros(3, device=device),
                                        FOV, w / h, NEAR, FAR, w, h)
    counts = torch.full((tiles,), count, dtype=torch.int32, device=device)
    return (counts, const, rows_t, gb_t), dict(tile_h=tile[0], tile_w=tile[1],
                                               tiles_x=w // tile[1])


def _light_rows(rng, n, radius):
    """n light rows in the frustum (identity view), culling radius `radius`
    (a scalar or (lo, hi))."""
    z = rng.uniform(1.0, 60.0, n)
    th = math.tan(FOV / 2.0)
    pos = np.stack([rng.uniform(-1, 1, n) * z * th * W / H, rng.uniform(-1, 1, n) * z * th, z],
                   -1)
    cull = np.full(n, radius) if np.isscalar(radius) else rng.uniform(*radius, n)
    return np.concatenate([pos, rng.uniform(0.2, 1.0, (n, 3)), rng.uniform(1, 8, (n, 1)),
                           np.tile([1.0, 0.1, 0.01], (n, 1)), pos, cull[:, None]], 1)


@pytest.mark.parametrize("n_lights", [31, 32, 33])
def test_kernel_caps_each_cluster_at_32_hits(device, n_lights):
    rows = _light_rows(np.random.default_rng(11), n_lights, 500.0)   # every cluster hit
    got, _ = _check_kernel(*_uniform_inputs(device, rows, n_lights, cap=128))
    assert (got[..., 3] == min(n_lights, 32)).all()


def test_kernel_flushes_chunk_sums_at_positions_127_128_129(device):
    rng = np.random.default_rng(12)
    rows = _light_rows(rng, 200, 0.0)                       # radius 0: never admitted
    rows[[127, 128, 129], 13] = 500.0                        # but these three, everywhere
    (counts, const, rows_t, gb_t), kw = _uniform_inputs(device, rows, 200, cap=256)
    got, want = _check_kernel((counts, const, rows_t, gb_t), kw)
    assert (got[..., 3] == 3).all() and (want[..., :3] > 0).any()
    # the sum of the three associates as (127) + (128 + 129): chunk 0, then chunk 1
    pos, n = lights_cuda.cluster_light_lists_reference(counts, const, rows_t, gb_t, **kw)
    assert (n == 3).all() and (pos[..., :3] == torch.tensor([127, 128, 129],
                                                             device=device)).all()


def test_kernel_walks_a_full_1024_list(device):
    rows = _light_rows(np.random.default_rng(13), 1024, (0.5, 3.0))
    rows[-4:, 13] = 500.0                                    # the list's last entries hit all
    got, want = _check_kernel(*_uniform_inputs(device, rows, 1024, cap=1024, depth=0.3))
    assert (got[..., 3] >= 4).all()
    assert (want[..., 3] < 32).any()                         # some walks reach the list's end


def test_kernel_with_every_pixel_masked(device):
    rows = _light_rows(np.random.default_rng(14), 300, (2.0, 15.0))
    got, want = _check_kernel(*_uniform_inputs(device, rows, 300, cap=384, masked=False))
    assert (got[..., :3] == 0).all()
    assert (got[..., 3] == want[..., 3]).all() and got[..., 3].max() > 0


def test_kernel_on_a_small_frame_with_hundreds_of_clusters_per_tile(device):
    h, w, tile = 48, 64, (24, 64)
    rng = np.random.default_rng(15)
    rows = torch.as_tensor(_light_rows(rng, 500, (2.0, 20.0)).astype(np.float32), device=device)
    nrm = rng.normal(size=(h, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    z_view = NEAR * FAR / (FAR - rng.uniform(0.05, 0.95, (h, w)) * (FAR - NEAR))
    t = lambda x, dt=np.float32: torch.as_tensor(np.asarray(x).astype(dt), device=device)  # noqa
    with recording(lights_cuda, "point_lights_kernel") as calls:
        lights_cuda.point_lights_tiled(
            rows, t(rng.uniform(0.05, 1.0, (h, w, 3))), t(nrm), t(rng.uniform(0.05, 1, (h, w))),
            t(rng.uniform(0, 1, (h, w))), t(z_view), t(rng.uniform(0, 1, (h, w)) > 0.1, bool),
            torch.eye(4, device=device), torch.zeros(3, device=device), FOV, w / h, NEAR, FAR,
            w, h, tile_h=tile[0], tile_w=tile[1], cap=512)
    (kargs, kw), = calls
    keys = lights_cuda.pixel_cluster_keys(kargs[1], kargs[3], **kw)
    assert min(torch.unique(k).numel() for k in keys) > 200
    _check_kernel(kargs, kw)


def _launches():
    return (LAUNCHES["raster_interp"], LAUNCHES["fused_cover"],
            LAUNCHES["resolve_shade"], LAUNCHES["deferred_shade"],
            LAUNCHES["env_resolve"], LAUNCHES["point_lights"])


def test_light_tile_frame_on_the_card_matches_the_cpu_frame(device):
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import (CAPTURE_WARMUP,
                                                                 DeferredRenderPipeline)
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera
    from direct12pbrrenderer_tpu_torch.tools.stress_scene import build_stress_scene

    scene = build_stress_scene(cells_x=16, cells_y=8, n_lights=72)
    cfg = RenderConfig(width=W, height=H, max_instances=2, max_lights=128,
                       max_triangles=2048, max_vertices=2048)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 4, 10])
    cam.rotate(0, math.pi, 0.3)
    knobs = dict(tile_h=24, tile_w=128, bin_cap=256, max_active_lights=128, atlas_max_dim=64)
    card = DeferredRenderPipeline(scene, cfg, device=device, **knobs)
    assert card.light_tile == (24, 128) and not card.use_fused_deferred
    cpu = DeferredRenderPipeline(scene, cfg, use_pallas=True, use_tex_kernel=True,
                                 device="cpu", **knobs)
    before = _launches()
    a = card.render(cam).cpu().numpy().astype(np.float64) / 255.0
    torch.cuda.synchronize()
    # A, B (3 texture covers + 1 env cover), C, not D, F, G a frame; the
    # first render captures the frame: its warm-up frames launch, then the replay
    frames = CAPTURE_WARMUP + 1
    assert [y - x for x, y in zip(before, _launches())] == [
        frames * n for n in (1, 4, 1, 0, 1, 1)]
    b = cpu.render(cam).numpy().astype(np.float64) / 255.0
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3
    assert card.last_stats == cpu.last_stats
    assert card.last_stats.visible_lights > 32
