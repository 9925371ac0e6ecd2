"""Kernel G's per-cluster admitted lists on the CPU: the plain version of
the CUDA kernel's step 2 (`lights_cuda.cluster_light_lists_reference`, one
list per distinct (tile, cluster)) against a per-pixel serial walk of the
plain version's sphere test and against `point_lights_kernel_reference`.

Scenarios at 256x96 with 24x128 tiles (identity view): the three of
`tests/test_torch_lights_cuda.py` (scattered lights, frustum-covering
lights that fill every cluster's cap of 32, 1000 lights with lists above
128 at cap 1024) and one with small culling spheres (radius 1-5) at cap
1024, where most clusters admit fewer than 32 of several hundred listed
lights, on both sides of 128-entry chunk boundaries, and where 1% of the
pixels have a NaN depth (masked out; their cluster admits nothing).

Bars: the lists and counts are the same float decisions on the same values,
but the cluster lists compute each AABB on (clusters, 1) tensors and the
per-pixel versions on (tiles, pixels, 1) ones, and PyTorch's CPU pow and
log may take other vector paths for other shapes: a one-ulp change at a
cluster slice edge can move one pixel's membership. So a pixel may differ
on at most max(1, 1e-4 of the pixels), the counter bar of chip_smoke.py and
the card tests; rgb summed over the admitted lights in the CUDA kernel's
order (serial within a 128-entry chunk, flushed at each chunk boundary)
within rtol 1e-4 / atol 1e-5 of the plain version on the masked pixels
whose counters agree.
"""

import functools
import math

import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu_torch.config import MAX_LIGHTS_PER_CLUSTER
from direct12pbrrenderer_tpu_torch.ops import lights_cuda

torch.set_num_threads(2)
H, W, TILE = 96, 256, (24, 128)
FOV, NEAR, FAR = math.pi / 3.0, 0.1, 100.0
SCENARIOS = {  # seed, lights, pool (= cap), culling radius range (None: covering)
    "scattered": (7, 130, 256, (2.0, 15.0)),
    "capped": (8, 64, 128, None),
    "lists_above_128": (9, 1000, 1024, (2.0, 15.0)),
    "sparse_nan_depth": (10, 1000, 1024, (1.0, 5.0)),
}


@functools.cache
def _kernel_inputs(name):
    """The kernel's staged inputs through `point_lights_tiled`'s steps:
    (counts, const, rows_t, gb_t, kwargs)."""
    seed, n, pool, radius = SCENARIOS[name]
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 60.0, n)
    th = math.tan(FOV / 2.0)
    pos = np.stack([rng.uniform(-1, 1, n) * z * th * W / H, rng.uniform(-1, 1, n) * z * th, z],
                   -1)
    cull = np.full(n, 500.0) if radius is None else rng.uniform(*radius, n)
    rows = np.concatenate([pos, rng.uniform(0.2, 1.0, (n, 3)), rng.uniform(1, 8, (n, 1)),
                           np.tile([1.0, 0.1, 0.01], (n, 1)), pos, cull[:, None]], 1)
    rows = torch.as_tensor(np.pad(rows, ((0, pool - n), (0, 0))).astype(np.float32))
    nrm = rng.normal(size=(H, W, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    depth = rng.uniform(0.05, 0.95, (H, W))
    z_view = NEAR * FAR / (FAR - depth * (FAR - NEAR))
    mask = rng.uniform(0, 1, (H, W)) > 0.1
    if name == "sparse_nan_depth":
        bad = rng.uniform(0, 1, (H, W)) < 0.01
        z_view[bad] = np.nan
        mask &= ~bad
    t = torch.as_tensor
    gb = (t(rng.uniform(0.05, 1.0, (H, W, 3)).astype(np.float32)), t(nrm.astype(np.float32)),
          t(rng.uniform(0.05, 1.0, (H, W)).astype(np.float32)),
          t(rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)), t(z_view.astype(np.float32)),
          t(mask))
    tiles_y, tiles_x = H // TILE[0], W // TILE[1]
    ids, counts = lights_cuda.tile_light_lists(rows, tiles_y, tiles_x, *TILE, W, H, FOV, W / H,
                                               NEAR, FAR, pool)
    const = lights_cuda.light_constants(torch.eye(4), torch.zeros(3), FOV, W / H, NEAR, FAR,
                                        W, H)
    return (torch.clamp(counts, max=pool), const, lights_cuda.stage_light_rows(rows, ids),
            lights_cuda.tile_gbuffer(*gb, *TILE),
            dict(tile_h=TILE[0], tile_w=TILE[1], tiles_x=tiles_x))


@functools.cache
def _lists(name):
    counts, const, rows_t, gb_t, kw = _kernel_inputs(name)
    return lights_cuda.cluster_light_lists_reference(counts, const, rows_t, gb_t, **kw)


@functools.cache
def _plain(name):
    counts, const, rows_t, gb_t, kw = _kernel_inputs(name)
    return lights_cuda.point_lights_kernel_reference(counts, const, rows_t, gb_t, **kw)


def _bar(n_pixels):
    return max(1, int(1e-4 * n_pixels))


def _serial_walk(counts, const, rows_t, gb_t, tile_h, tile_w, tiles_x):
    """Every pixel walks its tile's list in order with the plain version's
    sphere test against its own cluster AABB and a counter capped at 32."""
    s = lights_cuda._pixel_setup(const, gb_t, 0, tile_h=tile_h, tile_w=tile_w, tiles_x=tiles_x)
    aabb = [x[..., 0] for x in s.aabb]                           # each (tiles, p)
    listed = torch.clamp(counts, max=rows_t.shape[-1])[:, None]
    cnt = torch.zeros(gb_t.shape[:2], dtype=torch.int64)
    pos = torch.full((*gb_t.shape[:2], MAX_LIGHTS_PER_CLUSTER + 1), -1, dtype=torch.int32)
    for l in range(int(listed.max())):
        col = [rows_t[:, c, l:l + 1] for c in range(10, 14)]     # each (tiles, 1)
        ok = (lights_cuda._sphere_hits(aabb, *col) & (l < listed)
              & (cnt < MAX_LIGHTS_PER_CLUSTER))
        pos.scatter_(2, torch.where(ok, cnt, MAX_LIGHTS_PER_CLUSTER)[..., None], l)
        cnt += ok
    return pos[..., :MAX_LIGHTS_PER_CLUSTER], cnt.to(torch.int32)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_cluster_lists_equal_a_serial_walk_per_pixel(name):
    pos, n = _lists(name)
    want_pos, want_n = _serial_walk(*_kernel_inputs(name)[:4], **_kernel_inputs(name)[4])
    assert pos.shape == want_pos.shape and pos.dtype == torch.int32
    differ = (pos != want_pos).any(-1) | (n != want_n)
    assert int(differ.sum()) <= _bar(differ.numel())
    # the lists are ascending list positions, -1 padded past the count
    k = torch.arange(MAX_LIGHTS_PER_CLUSTER)
    assert ((pos >= 0) == (k < n[..., None])).all()
    assert (pos[..., 1:][pos[..., 1:] >= 0] > pos[..., :-1][pos[..., 1:] >= 0]).all()
    counts = _kernel_inputs(name)[0]
    if name == "capped":
        assert (n == MAX_LIGHTS_PER_CLUSTER).all()
    if name in ("lists_above_128", "sparse_nan_depth"):
        assert int(counts.max()) > 128
    if name == "sparse_nan_depth":
        crosses = (pos[..., 0] < 128) & (pos.max(-1).values >= 128)
        assert crosses.any()                          # a chunk flush inside a pixel's list
        nan_px = torch.isnan(_kernel_inputs(name)[3][..., 8])
        assert nan_px.any() and (n[nan_px] == 0).all()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_cluster_counts_equal_the_plain_counter(name):
    _, n = _lists(name)
    counter = _plain(name)[..., 3]
    differ = n.float() != counter
    assert int(differ.sum()) <= _bar(differ.numel())
    assert 0 < int(n.max()) <= MAX_LIGHTS_PER_CLUSTER


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_admitted_lights_in_chunk_flush_order_match_the_plain_version(name):
    counts, const, rows_t, gb_t, kw = _kernel_inputs(name)
    pos, n = _lists(name)
    s = lights_cuda._pixel_setup(const, gb_t, 0, **kw)
    tile = torch.arange(gb_t.shape[0])[:, None]
    acc = [torch.zeros(gb_t.shape[:2]) for _ in range(3)]
    part = [torch.zeros(gb_t.shape[:2]) for _ in range(3)]
    chunk = torch.full(gb_t.shape[:2], -1)
    flat = {k: getattr(s, k)[..., 0] if isinstance(getattr(s, k), torch.Tensor) else
            [x[..., 0] for x in getattr(s, k)]
            for k in ("posx", "posy", "posz", "vdx", "vdy", "vdz", "nx", "ny", "nz", "n_dot_v",
                      "a2", "k_geo", "g_v", "f0", "kd_alb")}
    sp = type(s)(**flat)
    for k in range(MAX_LIGHTS_PER_CLUSTER):
        live = k < n
        l = pos[..., k].clamp(min=0).long()
        flush = live & (l // lights_cuda.CHUNK != chunk)
        for c in range(3):
            acc[c] = torch.where(flush, acc[c] + part[c], acc[c])
            part[c] = torch.where(flush, 0.0, part[c])
        chunk = torch.where(flush, l // lights_cuda.CHUNK, chunk)
        lp = [rows_t[tile, j, l] for j in range(10)]             # each (tiles, p)
        lum, f_c = lights_cuda._light_terms(sp, lp)
        for c in range(3):
            part[c] = torch.where(live, part[c] + f_c[c] * (lp[3 + c] * lum), part[c])
    rgb = torch.stack([a + b for a, b in zip(acc, part)], -1).numpy()
    want = _plain(name).numpy()
    masked = (n.numpy() == want[..., 3]) & (gb_t[..., 9].numpy() > 0.5)
    assert masked.mean() > 0.8
    np.testing.assert_allclose(rgb[masked], want[..., :3][masked], rtol=1e-4, atol=1e-5)
    assert np.abs(want[..., :3][masked]).max() > 0


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pixels_of_one_cluster_share_a_bit_equal_aabb(name):
    """The premise of the kernel's grouping: pixels with one cluster key
    in one tile have the same AABB bit for bit."""
    counts, const, rows_t, gb_t, kw = _kernel_inputs(name)
    key = lights_cuda.pixel_cluster_keys(const, gb_t, **kw)
    s = lights_cuda._pixel_setup(const, gb_t, 0, **kw)
    full = key + torch.arange(key.shape[0])[:, None] * lights_cuda.KEYS_PER_TILE
    _, inv = torch.unique(full, return_inverse=True)
    inv = inv.flatten()
    member = torch.zeros(int(inv.max()) + 1, dtype=torch.long).scatter_(
        0, inv, torch.arange(inv.numel()))                     # one pixel of each cluster
    for x in s.aabb:
        bits = x[..., 0].flatten().view(torch.int32)
        assert torch.equal(bits, bits[member[inv]])
    assert max(torch.unique(k).numel() for k in key) > 8      # tiles span many clusters
