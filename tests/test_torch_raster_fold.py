"""The depth fold of kernels A and H (csrc/raster_fold.cuh) on the CPU.

The kernels reject a candidate for a 16x8 pixel rectangle when its integer
screen AABB misses the rectangle, and fold only the candidates that meet it.
That keeps every result only if a pixel that a listed candidate covers lies
inside the candidate's AABB, the premise binning already rests on:
`test_coverage_implies_inside_the_aabb` checks it with the plain fold's own
arithmetic on random scenes (near-plane crossings, duplicates, sub-pixel and
degenerate triangles) and on the stress scene.

`emulate_kernel_fold` repeats the kernels' bookkeeping in numpy, step for
step: the per-tile list limits ranked from the bin counts, lists under
the limit cut into slices of `slice_len` entries, 128-entry chunks, the block's band reject with a ballot and prefix
count per 32 entries (the in-order survivor compaction), one 16x8 rectangle
per warp with its ballot over the survivors, the fold of each candidate
that meets it in list order, coverage before depth, every product and sum
rounded on its own in float32, and the 64-bit key merge of a band's slices
with the winner's depth recomputed. It must equal the plain version
(`raster_cuda.rasterize_depth_reference`) bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu_torch.ops import raster as tr
from direct12pbrrenderer_tpu_torch.ops import raster_cuda as trc
from test_raster_pallas import _scene
from test_torch_raster_cuda import edge_case_scene

torch.set_num_threads(2)
F = np.float32


def _setup(clip, tris, w, h, valid=None):
    n = tris.shape[0]
    valid = torch.ones(n, dtype=torch.bool) if valid is None else torch.as_tensor(valid)
    return tr.setup_triangles(torch.as_tensor(np.array(clip)), torch.as_tensor(np.array(tris)),
                              valid, w, h)


def _random(seed, w, h, n=300):
    clip, tris = _scene(n, seed)
    return _setup(clip, tris, w, h)


def _near_plane(seed, w, h, n=200):
    """Large random triangles with vertices behind the camera (w <= 0) and
    clip z around [0, w], as in test_setup_triangles_near_plane_crossing."""
    rng = np.random.default_rng(seed)
    clip = rng.uniform(-2, 2, (3 * n, 4)).astype(np.float32)
    clip[:, 3] = rng.uniform(-0.5, 2.0, 3 * n)
    clip[:, 2] = clip[:, 3] * rng.uniform(-0.2, 1.2, 3 * n)
    return _setup(clip, np.arange(3 * n, dtype=np.int32).reshape(n, 3), w, h)


def _odd(seed, w, h):
    """Every triangle twice (the copy drawn later), sub-pixel triangles,
    zero-area triangles and a pool-padding mask."""
    clip, tris = _scene(150, seed)
    clip = np.asarray(clip).copy()
    rng = np.random.default_rng(seed + 7)
    tiny = np.repeat(rng.uniform(-1, 1, (100, 1, 4)), 3, 1).astype(np.float32)
    tiny[..., :2] += rng.uniform(-2e-3, 2e-3, (100, 3, 2))
    tiny[..., 3] = 1.0
    flat = tiny[:20].copy()
    flat[:, 2, :2] = flat[:, 0, :2]            # two equal vertices: zero area
    clip = np.concatenate([clip, tiny.reshape(-1, 4), flat.reshape(-1, 4)])
    t = np.arange(clip.shape[0], dtype=np.int32).reshape(-1, 3)
    tris = np.concatenate([t, t[:150]])
    valid = np.arange(tris.shape[0]) % 11 != 5
    return _setup(clip, tris, w, h, valid)


def _stress(seed, w, h):
    """The stress scene's terrain through the vertex stage at the smoke
    run's pose (a yaw of 0.1 per seed)."""
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.pipeline.scene_pack import pack_scene
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera
    from direct12pbrrenderer_tpu_torch.tools.stress_scene import build_stress_scene

    cfg = RenderConfig(w, h, max_instances=2)
    p = pack_scene(build_stress_scene(16, 8), cfg)
    cam = Camera(cfg.fov, w, h, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0.0, math.pi + 0.1 * seed, 0.35)
    vp = torch.as_tensor(np.asarray(cam.projection_matrix() @ cam.view_matrix(), np.float32))
    clip = tr.vertex_transform(torch.as_tensor(p.positions), torch.as_tensor(p.vtx_instance),
                               torch.as_tensor(p.model_mats), vp)
    return tr.setup_triangles(clip, torch.as_tensor(p.tris), torch.as_tensor(p.tri_valid), w, h)


SCENES = {"random": _random, "near_plane": _near_plane, "odd": _odd, "stress": _stress}


@pytest.mark.parametrize("scene,seed,shape", [
    ("random", 0, (256, 192, 24, 128)), ("random", 1, (320, 240, 12, 64)),
    ("near_plane", 0, (256, 192, 24, 128)), ("near_plane", 1, (320, 240, 24, 160)),
    ("near_plane", 2, (256, 192, 12, 64)), ("odd", 0, (256, 192, 24, 128)),
    ("odd", 1, (320, 240, 24, 160)), ("stress", 0, (256, 192, 24, 128)),
    ("stress", 1, (320, 240, 24, 160)),
])
def test_coverage_implies_inside_the_aabb(scene, seed, shape):
    """Every (pixel, listed candidate) pair that the plain fold's arithmetic
    accepts (all s_i >= 0, den > 0, 0 <= zc <= 1) has its pixel inside the
    candidate's integer AABB: the premise of the kernels' AABB rejects."""
    w, h, th, tw = shape
    setup = SCENES[scene](seed, w, h)
    bins = tr.bin_triangles(setup, h // th, w // tw, th, tw, 1024)
    assert int(bins.counts.max()) <= 1024
    px, py = tr._tile_pixel_centers(bins.ids.shape[0], w // tw, th, tw, 0, "cpu")
    px, py = px[:, :, None], py[:, :, None]
    accepted = 0
    for c in range(0, int(bins.counts.max()), 64):
        ids = bins.ids[:, c:c + 64]
        idc = ids.clamp(min=0).long()
        s0, s1, s2 = tr.edge_scores(px, py, setup.edges[idc][:, None])
        wv, zv = setup.w_clip[idc][:, None], setup.z[idc][:, None]
        den = (s0 * wv[..., 0] + s1 * wv[..., 1]) + s2 * wv[..., 2]
        zc = ((s0 * zv[..., 0] + s1 * zv[..., 1]) + s2 * zv[..., 2]) / torch.where(
            den == 0.0, 1.0, den)
        ok = ((s0 >= 0.0) & (s1 >= 0.0) & (s2 >= 0.0) & (den > 0.0) & (zc >= 0.0)
              & (zc <= 1.0) & (ids >= 0)[:, None, :])
        a = setup.aabb[idc][:, None]
        inside = ((a[..., 0] < px + 0.5) & (a[..., 2] > px - 0.5)
                  & (a[..., 1] < py + 0.5) & (a[..., 3] > py - 0.5))
        assert not (ok & ~inside).any(), f"{int((ok & ~inside).sum())} covered pixels outside"
        accepted += int(ok.sum())
    assert accepted > 0


def _meets(e, x0, x1, y0, y1):
    """Binning's overlap test of AABBs e (..., [xmin, ymin, xmax, ymax])."""
    return (e[..., 0] < x1) & (e[..., 2] > x0) & (e[..., 1] < y1) & (e[..., 3] > y0)


def emulate_kernel_fold(setup, bins, width, height, tile_h, tile_w, y_offset=0,
                        cap_small=None, hot_k=None, slice_len=trc.SLICE):
    """raster_fold.cuh's fold of every (tile, 8-row band, list slice) work
    item, in numpy, then the key merge of split bands: -> (tri_id, z) images
    as `rasterize_depth` returns them."""
    rows = trc.pack_depth_rows(setup).numpy()        # kernel H's rows
    ext = rows[:, 16:20]
    num_tiles, cap = bins.ids.shape
    cap_small, hot_k = trc.resolve_caps(cap, num_tiles, cap_small, hot_k)
    limits = kernel_limits(bins.counts.numpy(), cap, cap_small, hot_k)
    ids_all = bins.ids.numpy()
    warps = max(4, -(-tile_w // 16))           # raster_fold::block_threads / 32
    lane = np.arange(32)
    col = np.arange(warps)[:, None] * 16 + (lane & 15)[None]          # (warps, 32)
    row = (lane >> 4)[None, :, None] + 2 * np.arange(4)[None, None]   # (1, 32, 4)
    tri_id = np.full((height, width), -1, np.int32)
    zout = np.ones((height, width), np.float32)
    for tile in range(num_tiles):
        tx, ty = tile % (width // tile_w), tile // (width // tile_w)
        ox, oy = F(tx * tile_w), F(ty * tile_h) + F(y_offset)
        limit = int(limits[tile])
        n_slices = -(-limit // slice_len) if limit > slice_len else 1
        px = (col.astype(F) + F(0.5) + ox)[..., None]
        for band in range(-(-tile_h // 8)):
            n_rows = min(8, tile_h - 8 * band)
            lo = oy + F(8 * band)
            py = row.astype(F) + F(0.5) + lo
            keys = np.full((warps, 32, 4), 2 ** 64 - 1, np.uint64)
            for first in range(0, max(limit, 1), slice_len):
                z, pos = _fold_slice(rows, ext, ids_all[tile], first,
                                     min(slice_len, limit - first), ox, tile_w, lo,
                                     lo + F(n_rows), px, py, warps)
                if n_slices == 1:
                    break
                # (bits(zc) with -0.0 as +0.0) << 32 | list position; atomicMin
                key = ((z.view(np.uint32) & np.uint32(0x7fffffff)).astype(np.uint64)
                       << np.uint64(32)) | pos.astype(np.uint32).astype(np.uint64)
                keys = np.where(pos >= 0, np.minimum(keys, key), keys)
            if n_slices > 1:   # the band's last slice: decode, recompute zc
                pos = np.where(keys == 2 ** 64 - 1, -1, (keys & np.uint64(0xffffffff))
                               .astype(np.int64)).astype(np.int32)
                for w, ln, k in zip(*np.nonzero(pos >= 0)):
                    r = rows[ids_all[tile, pos[w, ln, k]]]
                    z[w, ln, k] = _depth_at(r, px[w, ln, 0], py[0, ln, k])
            valid = (col[..., None] < tile_w) & (row < n_rows)                # (warps, 32, 4)
            gy = ty * tile_h + 8 * band + np.broadcast_to(row, valid.shape)[valid]
            gx = tx * tile_w + np.broadcast_to(col[..., None], valid.shape)[valid]
            ids = np.where(pos >= 0, ids_all[tile, np.maximum(pos, 0)], -1)
            tri_id[gy, gx] = ids[valid]
            zout[gy, gx] = np.where(ids[valid] < 0, F(1), z[valid])
    return torch.as_tensor(tri_id), torch.as_tensor(zout)


def kernel_limits(counts, cap, cap_small, hot_k):
    """fold_tiles' list limits from the bin counts: a tile above cap_small
    keeps its clamped count when fewer than hot_k tiles rank before it (a
    larger clamped count, or the same count at a lower tile index), else
    folds cap_small entries."""
    c = np.minimum(counts, cap)
    limits = c.copy()
    for t in np.flatnonzero(c > cap_small):
        rank = int(((c > c[t]) | ((c == c[t]) & (np.arange(c.size) < t))).sum())
        if rank >= hot_k:
            limits[t] = cap_small
    return limits


@pytest.mark.parametrize("seed,tiles,cap,cap_small,hot_k", [
    (0, 675, 8192, 2048, 112), (1, 40, 512, 128, 3), (2, 40, 512, 128, 0),
    (3, 300, 1024, 256, 50), (4, 7, 256, 256, 0), (5, 2700, 2048, 512, 450)])
def test_kernel_limits_equal_tile_limits(seed, tiles, cap, cap_small, hot_k):
    """The kernels rank the hot tiles themselves; on counts with many ties
    across the hot set's edge, and overflowing counts above the cap, the
    rank rule picks tile_limits' (lax.top_k's) limits exactly."""
    rng = np.random.default_rng(seed)
    counts = rng.choice([0, cap_small // 2, cap_small, cap_small + 1, cap - 1, cap, 2 * cap],
                        tiles).astype(np.int32)
    want = trc.tile_limits(torch.as_tensor(counts), cap, cap_small, hot_k).numpy()
    got = kernel_limits(counts, cap, cap_small, hot_k)
    assert (counts > cap_small).sum() > hot_k or hot_k == 0 or tiles < 10
    np.testing.assert_array_equal(got, want)


def _fold_slice(rows, ext, ids_row, first, n, ox, tile_w, lo, hi, px, py, warps):
    """fold_band over list entries [first, first + n) of one tile's list:
    -> (best_z, best_pos) (warps, 32, 4)."""
    best_z = np.full((warps, 32, 4), np.inf, np.float32)
    best_pos = np.full((warps, 32, 4), -1, np.int32)
    for c in range(-(-n // 128)):
        # stager thread tid: entry tid of the chunk
        j = c * 128 + np.arange(128)
        ids = np.where(j < n, ids_row[(first + j) % ids_row.shape[0]], -1)
        e = np.where((ids >= 0)[:, None], ext[np.maximum(ids, 0)], F(0))
        hit = (ids >= 0) & _meets(e, ox, ox + F(tile_w), lo, hi)
        # ballot per 32 entries: survivors of lower groups, then lower lanes
        group = hit.reshape(4, 32)
        rank = np.cumsum(group, 1) - group
        slot = ((np.cumsum(group.sum(1)) - group.sum(1))[:, None] + rank).reshape(-1)
        m_all = int(hit.sum())
        st_pos = np.empty(m_all, np.int32)
        st_ext = np.empty((m_all, 4), np.float32)
        st_pos[slot[hit]] = (first + j)[hit]
        st_ext[slot[hit]] = e[hit]
        for w in range(warps):
            if w * 16 >= tile_w:
                continue                        # a padding warp owns no pixel
            x0, x1 = ox + F(16 * w), ox + F(min(16 * w + 16, tile_w))
            for j0 in range(0, m_all, 32):
                m = _meets(st_ext[j0:j0 + 32], x0, x1, lo, hi)
                for jj in j0 + np.flatnonzero(m):  # __ffs order: list order
                    _fold_one(rows[ids_row[st_pos[jj]]], st_pos[jj], px[w], py[0],
                              best_z[w], best_pos[w])
    return best_z, best_pos


def _fold_one(r, pos, px, py, best_z, best_pos):
    """fold_one: the candidate's edge scores first; den, num and the division
    only where all three are >= 0; a strict `<` keeps the earlier entry."""
    a0, a1, a2 = px * r[0], px * r[3], px * r[6]
    s0 = (a0 + py * r[1]) + r[2]
    s1 = (a1 + py * r[4]) + r[5]
    s2 = (a2 + py * r[7]) + r[8]
    cov = (s0 >= 0) & (s1 >= 0) & (s2 >= 0)
    if not cov.any():
        return
    den = (s0 * r[12] + s1 * r[13]) + s2 * r[14]
    ok = cov & (den > 0)
    num = (s0 * r[9] + s1 * r[10]) + s2 * r[11]
    zc = num / np.where(ok, den, F(1))
    ok &= (zc >= 0) & (zc <= 1) & (zc < best_z)
    best_z[ok] = zc[ok]
    best_pos[ok] = pos


def _depth_at(r, px, py):
    """depth_at: a winner's zc recomputed with the fold's rounding."""
    s0 = (px * r[0] + py * r[1]) + r[2]
    s1 = (px * r[3] + py * r[4]) + r[5]
    s2 = (px * r[6] + py * r[7]) + r[8]
    return ((s0 * r[9] + s1 * r[10]) + s2 * r[11]) / ((s0 * r[12] + s1 * r[13]) + s2 * r[14])


@pytest.mark.parametrize("scene,seed,shape,cap,caps,y_offset,slice_len", [
    ("random", 0, (256, 192, 24, 128), 128, {}, 0, trc.SLICE),
    ("random", 2, (320, 240, 12, 64), 256, {}, 0, 128),
    ("odd", 0, (256, 192, 24, 128), 512, {"cap_small": 128, "hot_k": 3}, 0, 128),
    ("odd", 1, (320, 200, 20, 40), 512, {}, 0, trc.SLICE),
    ("near_plane", 1, (320, 240, 24, 160), 256, {}, 48, 128),
    ("stress", 0, (256, 192, 24, 128), 1024, {"cap_small": 128, "hot_k": 4}, 0, 256),
])
def test_kernel_fold_emulation_equals_plain_version(scene, seed, shape, cap, caps, y_offset,
                                                    slice_len):
    """The kernels' bookkeeping (in-order compaction, warp rectangles, the
    padding warps of narrow tiles, short last bands, y_offset, lists split
    into slices and merged by key) folds to the plain version's ids and
    depths bit for bit."""
    w, h, th, tw = shape
    setup = SCENES[scene](seed, w, h)
    bins = tr.bin_triangles(setup, h // th, w // tw, th, tw, cap, y_offset=y_offset)
    ids_e, z_e = emulate_kernel_fold(setup, bins, w, h, th, tw, y_offset, **caps,
                                     slice_len=slice_len)
    ids_p, z_p = trc.rasterize_depth_reference(setup, bins, w, h, th, tw, y_offset, **caps)
    assert (ids_p >= 0).any()
    assert torch.equal(ids_e, ids_p)
    assert torch.equal(z_e.view(torch.int32), z_p.view(torch.int32))


@pytest.mark.parametrize("kind,slice_len", [
    ("subpixel", trc.SLICE), ("duplicates", 128), ("depth_bounds", 128),
    ("warp_edges", 128), ("nan_scores", 128)])
def test_kernel_fold_emulation_on_the_folds_hard_cases(kind, slice_len):
    """The card tests' hard cases (test_torch_raster_cuda.edge_case_scene)
    through the emulation, with lists split into slices: ties of duplicates
    split across chunks and slices, -0.0 against +0.0 and zc exactly 0 and
    1, AABBs on the warp rectangles' edges; and triangles whose edge scores
    are NaN everywhere (never accepted)."""
    clip, tris, w, h, (th, tw), cap = edge_case_scene(
        "duplicates" if kind == "nan_scores" else kind, torch.device("cpu"))
    n = tris.shape[0]
    setup = tr.setup_triangles(clip, tris, torch.ones(n, dtype=torch.bool), w, h)
    if kind == "nan_scores":
        nan_rows = torch.arange(n) % 3 == 0
        setup = setup._replace(edges=torch.where(nan_rows[:, None, None], float("nan"),
                                                 setup.edges))
    bins = tr.bin_triangles(setup, h // th, w // tw, th, tw, cap)
    ids_e, z_e = emulate_kernel_fold(setup, bins, w, h, th, tw, slice_len=slice_len)
    ids_p, z_p = trc.rasterize_depth_reference(setup, bins, w, h, th, tw)
    assert (ids_p >= 0).any() and int(bins.counts.max()) > slice_len
    if kind == "depth_bounds":   # a -0.0 winner
        assert ((ids_p >= 0) & (z_p.view(torch.int32) == -2 ** 31)).any()
    if kind == "nan_scores":
        assert (ids_p[ids_p >= 0] % 3 != 0).all()
    assert torch.equal(ids_e, ids_p)
    assert torch.equal(z_e.view(torch.int32), z_p.view(torch.int32))


def test_depth_rows_layout():
    """Kernel H's (T, 20) rows: pack_raster_rows' raster columns 0:15 and the
    AABB (`raster_extents`) at 16:20, every column -3e38 for an invalid
    triangle; kernel A's rows64 carries the same AABB in columns 56:60."""
    setup = _odd(0, 256, 192)
    rows = trc.pack_depth_rows(setup)
    ext = trc.raster_extents(setup)
    v = setup.valid
    assert rows.shape == (setup.aabb.shape[0], 20) and rows.dtype == torch.float32
    assert rows.is_contiguous() and not v.all()
    assert torch.equal(rows[v, :15], trc.pack_raster_rows(setup)[v, :15])
    assert torch.equal(rows[:, 16:], ext) and torch.equal(ext[v], setup.aabb[v])
    assert (rows[~v] == -3e38).all()
    rows64 = trc.pack_rows64(setup, torch.zeros((v.shape[0], 40)))
    assert torch.equal(rows64[:, 56:60], ext)


@pytest.mark.parametrize("seed", [0, 1])
def test_poisoned_aabb_meets_no_rectangle(seed):
    """An invalid triangle's AABB (-3e38) fails binning's overlap test for
    every band and warp rectangle, wherever the triangle's own box lies."""
    setup = _odd(seed, 256, 192)
    ext = trc.raster_extents(setup)[~setup.valid]
    x0 = torch.arange(0, 256, 16, dtype=torch.float32)[:, None, None]
    y0 = torch.arange(0, 192, 8, dtype=torch.float32)[None, :, None]
    assert ext.shape[0] > 0
    assert not _meets(ext[None, None], x0, x0 + 16, y0, y0 + 8).any()


def _launch_tensors():
    setup = _random(0, 256, 192)
    bins = tr.bin_triangles(setup, 8, 2, 24, 128, 128)
    rows = trc.pack_depth_rows(setup)
    scratch = trc.merge_scratch(256, 192, 24, 16, "cpu")
    return rows, rows[:, 16:20], bins.ids, bins.counts, scratch


@pytest.mark.parametrize("fault", ["counts_int64", "counts_strided", "ext_shape", "ext_f64",
                                   "rows_misaligned", "ext_strided", "ids_shape",
                                   "scratch_int32", "scratch_short"])
def test_launch_tensors_are_checked(fault):
    """The launchers refuse what the kernel does not take (raise, never fall
    back): the bin counts' dtype, shape and contiguity, the AABBs' shape, dtype and
    layout, 16-byte alignment, the bin ids' shape, the merge scratch's dtype
    and size."""
    rows, ext, ids, counts, scratch = _launch_tensors()
    check = trc._check_kernel_tensors
    check(rows, ext, ids, counts, scratch, 16, 192, 256, 24)   # as built: accepted
    if fault == "counts_int64":
        counts = counts.long()
    elif fault == "counts_strided":
        counts = torch.stack([counts, counts], 1)[:, 0]
    elif fault == "ext_shape":
        ext = ext[:, :2].contiguous()
    elif fault == "ext_f64":
        ext = ext.double()
    elif fault == "rows_misaligned":
        rows = torch.cat([torch.zeros(1), rows.reshape(-1)])[1:].view(rows.shape)
    elif fault == "ext_strided":
        ext = torch.cat([ext, ext], 1)[:, ::2]
    elif fault == "ids_shape":
        ids = ids[:8]
    elif fault == "scratch_int32":
        scratch = scratch.int()
    elif fault == "scratch_short":
        scratch = scratch[:-1]
    with pytest.raises(ValueError):
        check(rows, ext, ids, counts, scratch, 16, 192, 256, 24)


def test_tile_wider_than_the_kernel_raises():
    setup = _random(0, 1024, 48)
    bins = tr.bin_triangles(setup, 12, 1, 4, 1024, 128)
    half = tr.bin_triangles(setup, 12, 2, 4, 512, 128)
    trc._check_raster_args(trc.pack_raster_rows(setup), 1024, 48, 4, 512, half, 16)
    with pytest.raises(ValueError, match="exceeds the kernel's 512"):
        trc._check_raster_args(trc.pack_raster_rows(setup), 1024, 48, 4, 1024, bins, 16)
