"""Kernel A (csrc/raster_interp.cu) against its plain PyTorch version on a
CUDA device. Needs the card and the CUDA toolkit: marked `cuda`, skipped
elsewhere. On a GPU machine without JAX (tests/conftest.py imports it):
`python -m pytest --noconftest tests/test_torch_raster_cuda.py`.

Both sides evaluate the same float32 formulas with every product and sum
rounded separately, so winners, z and planes are expected bit-equal; the
first tests keep the CPU tests' bars (id mismatch < 1e-4, z atol 1e-4,
interp rtol 1e-3 / atol 1e-4, material planes bit-equal), the fold's hard
cases and the band offsets are held bit for bit.
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_triangles
from direct12pbrrenderer_tpu_torch.ops import raster, raster_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,seed,cap,caps,shape", [
    (300, 0, 128, {}, (256, 192, 24, 128)),
    (300, 1, 128, {}, (256, 192, 24, 128)),
    (2500, 3, 512, {"cap_small": 128, "hot_k": 6}, (256, 192, 24, 128)),
    # tile heights that are not a multiple of the kernel's 8-row band
    (2500, 3, 512, {}, (256, 192, 12, 64)),
    (2500, 4, 512, {}, (320, 240, 60, 160)),
])
def test_kernel_matches_plain_version(device, n, seed, cap, caps, shape):
    w, h, th, tw = shape
    clip, tris, payload = random_triangles(n, seed, device)
    setup = raster.setup_triangles(clip, tris, torch.ones(n, dtype=torch.bool, device=device),
                                   w, h)
    bins = raster.bin_triangles(setup, h // th, w // tw, th, tw, cap)
    rows64 = raster_cuda.pack_rows64(setup, payload)
    before = raster_cuda.rasterize_interp.launches
    ids_k, z_k, pl_k = (t.cpu().numpy() for t in raster_cuda.rasterize_interp(
        setup, bins, rows64, w, h, th, tw, **caps))
    torch.cuda.synchronize()
    assert raster_cuda.rasterize_interp.launches == before + 1
    ids_p, z_p, pl_p = (t.cpu().numpy() for t in raster_cuda.rasterize_interp_reference(
        setup, bins, rows64, w, h, th, tw, **caps))
    mismatch = ids_k != ids_p
    assert mismatch.mean() < 1e-4
    agree = ~mismatch
    assert (agree & (ids_p >= 0)).any()
    np.testing.assert_array_equal(pl_k[8:, agree], pl_p[8:, agree])
    np.testing.assert_allclose(pl_k[:8, agree], pl_p[:8, agree], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(z_k[agree], z_p[agree], atol=1e-4)


@pytest.mark.parametrize("tile", [(24, 128), (12, 64)])
def test_pipeline_frame_through_kernel_matches_plain_path(device, tile):
    """A small frame of the use_tex_kernel=False path on the card through
    kernel A against use_pallas=False, at the JAX package's fidelity bar
    (rmse <= 1e-3 on uint8/255)."""
    import math

    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera
    from direct12pbrrenderer_tpu_torch.tools.stress_scene import build_stress_scene
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import (CAPTURE_WARMUP,
                                                                 DeferredRenderPipeline)

    scene = build_stress_scene(64, 32)
    cfg = RenderConfig(256, 192, max_instances=2)
    knobs = dict(tile_h=tile[0], tile_w=tile[1], bin_cap=4096, atlas_max_dim=256,
                 prefilter_size=16, brdf_lut_size=32, use_tex_kernel=False, device=device)
    kern = DeferredRenderPipeline(scene, cfg, use_pallas=True, **knobs)
    plain = DeferredRenderPipeline(scene, cfg, use_pallas=False, **knobs)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    before = raster_cuda.rasterize_interp.launches
    a = kern.render(cam).cpu().numpy().astype(np.float64) / 255.0
    b = plain.render(cam).cpu().numpy().astype(np.float64) / 255.0
    # the first render captures the frame: its warm-up frames launch, then the replay
    assert raster_cuda.rasterize_interp.launches == before + CAPTURE_WARMUP + 1
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3
    assert kern.last_stats.bin_overflow == plain.last_stats.bin_overflow == 0


def screen_triangles(xy, z, width, height, device):
    """Triangles given in screen pixels xy (n, 3, 2) with clip z (n, 3) and
    w = 1, each wound so that setup keeps it: (clip (3n, 4), tris (n, 3))."""
    xy, z = np.asarray(xy, np.float64), np.asarray(z, np.float32)
    n = xy.shape[0]
    clip = np.zeros((n, 3, 4), np.float32)
    clip[..., 0] = xy[..., 0] / width * 2 - 1
    clip[..., 1] = 1 - xy[..., 1] / height * 2
    clip[..., 2], clip[..., 3] = z, 1.0
    tris = torch.arange(3 * n, dtype=torch.int32, device=device).reshape(n, 3)
    clip = torch.as_tensor(clip.reshape(-1, 4), device=device)
    ok = raster.setup_triangles(clip, tris, torch.ones(n, dtype=torch.bool, device=device),
                                width, height).valid
    return clip, torch.where(ok[:, None], tris, tris[:, [0, 2, 1]])


def edge_case_scene(kind, device):
    """(clip, tris, width, height, tile, cap) of one hard case of the fold:
    'subpixel': 3000 sub-pixel triangles in one tile's list;
    'duplicates': 1500 triangles in the top two tile rows drawn twice, the
      copies more than a slice (raster_cuda.SLICE entries) apart;
    'depth_bounds': triangles at clip z = 0 and -0.0 drawn twice, in both
      orders and more than a slice apart in the lists, and at clip z = w (zc
      exactly 0, -0.0 and 1), among random ones;
    'warp_edges': triangles with vertices on the 16-column warp rectangles'
      edges and on pixel centers (AABBs touching a rectangle's edge exactly,
      edge scores exactly 0)."""
    rng = np.random.default_rng(11)
    if kind == "subpixel":
        c = rng.uniform((0, 0), (128, 24), (3000, 1, 2))
        xy = c + rng.uniform(-0.6, 0.6, (3000, 3, 2))
        return (*screen_triangles(xy, rng.uniform(0.1, 0.9, (3000, 3)), 256, 192, device),
                256, 192, (24, 128), 4096)
    if kind == "duplicates":
        xy = rng.uniform((0, 0), (128, 48), (1500, 1, 2)) + rng.uniform(-6, 6, (1500, 3, 2))
        z = rng.uniform(0.05, 0.95, (1500, 3))
        return (*screen_triangles(np.concatenate([xy, xy]), np.concatenate([z, z]), 256, 192,
                                  device), 256, 192, (24, 128), 4096)
    if kind == "depth_bounds":
        # 10 triangles at +0.0, drawn again at -0.0 3000 random triangles
        # later (a tie: the first drawn keeps the pixel), 10 others at -0.0
        # then +0.0, and 10 at clip z = w (zc = den / den = 1 exactly) where
        # no random triangle hides them
        tri = [[0, 0], [30, 0], [0, 30]]
        p = rng.uniform((0, 0), (160, 160), (20, 1, 2)) + tri
        far = rng.uniform((200, 0), (226, 160), (10, 1, 2)) + tri
        rnd = rng.uniform((0, 0), (150, 192), (6000, 1, 2)) + rng.uniform(-40, 40, (6000, 3, 2))
        xy = np.concatenate([p[:10], rnd[:3000], p[:10], p[10:], rnd[3000:], p[10:], far])
        z = np.concatenate([np.full((10, 3), 0.0), rng.uniform(0, 1, (3000, 3)),
                            np.full((20, 3), -0.0), rng.uniform(0, 1, (3000, 3)),
                            np.full((10, 3), 0.0), np.full((10, 3), 1.0)])
        return (*screen_triangles(xy, z, 256, 192, device), 256, 192, (24, 128), 4096)
    assert kind == "warp_edges"
    x0 = rng.integers(0, 16, (3000, 1)) * 16.0 + rng.choice([-1.0, -0.5, 0.0, 0.5], (3000, 1))
    y0 = rng.integers(0, 64, (3000, 1)) * 4.0 + rng.choice([0.0, 0.5], (3000, 1))
    dx = rng.choice([0.5, 1.0, 8.0, 16.0], (3000, 1))
    dy = rng.choice([0.5, 1.0, 8.0], (3000, 1))
    xy = np.stack([np.concatenate([x0, x0 + dx, x0], 1),
                   np.concatenate([y0, y0, y0 + dy], 1)], -1).clip(0, 256)
    return (*screen_triangles(xy, rng.uniform(0, 1, (3000, 3)), 256, 256, device),
            256, 256, (32, 128), 1024)


@pytest.mark.parametrize("kind", ["subpixel", "duplicates", "depth_bounds", "warp_edges"])
def test_kernel_bit_equal_on_the_folds_hard_cases(device, kind):
    """Kernel A against its plain version bit for bit (ids, z, planes) where
    the fold's chunking, rejects and tie rule are most exposed; all but
    'warp_edges' have lists longer than a slice, split across blocks and
    merged by key (ties and -0.0 against +0.0 in different slices)."""
    clip, tris, w, h, (th, tw), cap = edge_case_scene(kind, device)
    n = tris.shape[0]
    setup = raster.setup_triangles(clip, tris, torch.ones(n, dtype=torch.bool, device=device),
                                   w, h)
    bins = raster.bin_triangles(setup, h // th, w // tw, th, tw, cap)
    assert int(bins.counts.max()) <= cap
    if kind != "warp_edges":
        assert int(bins.counts.max()) > raster_cuda.SLICE
    if kind == "subpixel":
        assert int(bins.counts.max()) > 2048
    if kind == "duplicates":   # some copy sits more than one slice after its original
        ids = bins.ids.cpu().numpy()
        gap = [np.flatnonzero(r == k + n // 2)[0] - np.flatnonzero(r == k)[0]
               for r in ids for k in r[(r >= 0) & (r < n // 2)]]
        assert max(gap) > raster_cuda.SLICE
    payload = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (n, 40)),
                              dtype=torch.float32, device=device)
    rows64 = raster_cuda.pack_rows64(setup, payload)
    got = raster_cuda.rasterize_interp(setup, bins, rows64, w, h, th, tw)
    want = raster_cuda.rasterize_interp_reference(setup, bins, rows64, w, h, th, tw)
    assert (want[0] >= 0).any() and int(bins.counts.max()) > raster_cuda.CHUNK
    if kind == "depth_bounds":
        hit = want[0] >= 0
        assert (hit & (want[1] == 0)).any() and (hit & (want[1] == 1)).any()
        assert (hit & (want[1].view(torch.int32) == -2 ** 31)).any()   # a -0.0 winner
    for g, r in zip(got, want):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


@pytest.mark.parametrize("shape,y_offset,caps", [
    ((320, 240, 24, 160), 24, {}),
    ((256, 192, 12, 64), 48, {"cap_small": 128, "hot_k": 5}),
    ((320, 240, 24, 160), 240, {"cap_small": 128, "hot_k": 3}),
])
def test_kernel_bit_equal_on_band_offsets(device, shape, y_offset, caps):
    """A band of a taller frame (y_offset) at the planar-tex cell's 24x160
    tile and the tests' 12x64 tile, kernel against plain bit for bit."""
    w, h, th, tw = shape
    clip, tris, payload = random_triangles(3000, 6, device)
    setup = raster.setup_triangles(clip, tris, torch.ones(3000, dtype=torch.bool,
                                                          device=device), w, h + y_offset)
    bins = raster.bin_triangles(setup, h // th, w // tw, th, tw, 512, y_offset=y_offset)
    rows64 = raster_cuda.pack_rows64(setup, payload)
    args = (setup, bins, rows64, w, h, th, tw, y_offset)
    got = raster_cuda.rasterize_interp(*args, **caps)
    want = raster_cuda.rasterize_interp_reference(*args, **caps)
    assert (want[0] >= 0).any()
    for g, r in zip(got, want):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


def test_kernel_exact_ties_go_to_the_earliest_list_entry(device):
    """Every triangle drawn twice (ids k and k + n): the kernel keeps the
    first copy at every covered pixel."""
    n = 300
    clip, tris, _ = random_triangles(n, 0, device)
    tris2 = torch.cat([tris, tris])
    setup = raster.setup_triangles(clip, tris2, torch.ones(2 * n, dtype=torch.bool,
                                                           device=device), 256, 192)
    bins = raster.bin_triangles(setup, 8, 2, 24, 128, 512)
    rows64 = raster_cuda.pack_rows64(setup, torch.zeros((2 * n, 40), device=device))
    ids_k = raster_cuda.rasterize_interp(setup, bins, rows64, 256, 192, 24, 128)[0]
    ids_p = raster_cuda.rasterize_interp_reference(setup, bins, rows64, 256, 192, 24, 128)[0]
    assert (ids_k >= 0).any() and (ids_k < n).all()
    assert torch.equal(ids_k, ids_p)


def test_kernels_leave_their_scratch_all_ones(device):
    """Kernels A and H reuse one merge scratch per shape and stream: every
    launch, split bands included, leaves its keys and counters all ones, so
    repeated launches on one scratch give the same bits."""
    clip, tris, w, h, (th, tw), cap = edge_case_scene("subpixel", device)
    n = tris.shape[0]
    setup = raster.setup_triangles(clip, tris, torch.ones(n, dtype=torch.bool, device=device),
                                   w, h)
    bins = raster.bin_triangles(setup, h // th, w // tw, th, tw, cap)
    rows64 = raster_cuda.pack_rows64(setup, torch.zeros((n, 40), device=device))
    args = (setup, bins, rows64, w, h, th, tw)
    first = raster_cuda.rasterize_interp(*args)
    scratch = raster_cuda._scratch(w, h, th, bins.ids.shape[0], device)
    for _ in range(3):
        ids_h, z_h = raster_cuda.rasterize_depth(setup, bins, w, h, th, tw)
        again = raster_cuda.rasterize_interp(*args)
        torch.cuda.synchronize()
        assert (scratch == -1).all()
        for g, r in zip(again, first):
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        assert torch.equal(ids_h, first[0]) and torch.equal(z_h, first[1])
