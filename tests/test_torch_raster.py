"""The port's ops/raster.py and ops/raster_cuda.py against the JAX package.

Inputs are the JAX raster tests' random-triangle scenes (numpy, fixed
seeds). Binning is integer work and must be bit-equal. The depth folds
evaluate the same float32 formulas, but XLA's einsum may associate the edge
score sums differently from the port's explicit (a*b + c*d) + e, so — as in
tests/test_raster_pallas.py — winners may flip where two triangles meet at
numerically equal depth (below 1e-4 of the pixels), and where the winners
agree z is within 1e-4, the material planes are bit-equal (a copy of the
winner's row) and the interpolated planes are within rtol 1e-3 / atol 1e-4
(the same formula contracted in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import raster as jr
from direct12pbrrenderer_tpu.ops import raster_pallas as jrp
from direct12pbrrenderer_tpu_torch.ops import raster as tr
from direct12pbrrenderer_tpu_torch.ops import raster_cuda as trc
from test_raster_pallas import _rows64, _scene

torch.set_num_threads(2)
W, H, TILE_H, TILE_W = 256, 192, 24, 128


def _t(x):
    return torch.as_tensor(np.array(x))


def _setups(n, seed, w=W, h=H):
    """(JAX setup, the same setup as torch tensors, port's own setup)."""
    clip, tris = _scene(n, seed)
    js = jr.setup_triangles(clip, tris, jnp.ones(tris.shape[0], bool), w, h)
    ts = tr.TriangleSetup(*(_t(a) for a in js))
    own = tr.setup_triangles(_t(clip), _t(tris), torch.ones(tris.shape[0], dtype=torch.bool),
                             w, h)
    return js, ts, own


@pytest.mark.parametrize("seed", [0, 1])
def test_setup_triangles_matches(seed):
    js, _, own = _setups(300, seed)
    for name in ("xy", "z", "w_clip", "edges"):
        np.testing.assert_allclose(getattr(own, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(own.aabb.numpy(), np.asarray(js.aabb))
    np.testing.assert_array_equal(own.valid.numpy(), np.asarray(js.valid))


def test_setup_triangles_near_plane_crossing():
    """Triangles with vertices behind the camera (clipless setup branch)."""
    rng = np.random.default_rng(9)
    clip = rng.uniform(-2, 2, (90, 4)).astype(np.float32)
    clip[:, 3] = rng.uniform(-0.5, 2.0, 90)
    tris = np.arange(90, dtype=np.int32).reshape(30, 3)
    js = jr.setup_triangles(jnp.asarray(clip), jnp.asarray(tris), jnp.ones(30, bool), W, H)
    ts = tr.setup_triangles(_t(clip), _t(tris), torch.ones(30, dtype=torch.bool), W, H)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.aabb.numpy(), np.asarray(js.aabb))
    v = np.asarray(js.valid)
    np.testing.assert_allclose(ts.edges.numpy()[v], np.asarray(js.edges)[v], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("cap", [128, 512])
def test_bin_triangles_bit_equal(cap):
    js, ts, _ = _setups(2500, 3)
    jb = jr.bin_triangles(js, H // TILE_H, W // TILE_W, TILE_H, TILE_W, cap)
    tb = tr.bin_triangles(ts, H // TILE_H, W // TILE_W, TILE_H, TILE_W, cap)
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))


@pytest.mark.parametrize("cap1", [300, 1200, 2500])
def test_bin_triangles_hier_bit_equal(cap1):
    """Both branches of the fine-pass width choice (host branch here,
    lax.cond there) and the supertile-overflow path."""
    w, h, th, tw = 512, 384, 24, 64
    js, ts, _ = _setups(2500, 3, w, h)
    args = (h // th, w // tw, th, tw, 128)
    jb = jr.bin_triangles_hier(js, *args, cap1=cap1)
    tb = tr.bin_triangles_hier(ts, *args, cap1=cap1)
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))


def _check_fold(ids_t, z_t, ids_j, z_j):
    ids_t, ids_j = ids_t.numpy(), np.asarray(ids_j)
    mismatch = ids_t != ids_j
    assert mismatch.mean() < 1e-4, f"{mismatch.sum()} id mismatches"
    agree = ~mismatch
    assert (agree & (ids_j >= 0)).sum() > 0
    np.testing.assert_allclose(z_t.numpy()[agree], np.asarray(z_j)[agree], atol=1e-4)
    return agree


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_rasterize_matches(seed):
    js, ts, _ = _setups(300, seed)
    jb = jr.bin_triangles(js, H // TILE_H, W // TILE_W, TILE_H, TILE_W, 128)
    tb = tr.Bins(_t(jb.ids), _t(jb.counts))
    ids_j, z_j = jr.rasterize(js, jb, W, H, TILE_H, TILE_W)
    ids_t, z_t = tr.rasterize(ts, tb, W, H, TILE_H, TILE_W)
    _check_fold(ids_t, z_t, ids_j, z_j)


@pytest.mark.parametrize("n,seed,cap,two_pass", [
    (300, 0, 128, False), (300, 1, 128, False), (2500, 3, 512, True)])
def test_rasterize_interp_reference_matches_pallas(n, seed, cap, two_pass):
    js, ts, _ = _setups(n, seed)
    jb = jr.bin_triangles(js, H // TILE_H, W // TILE_W, TILE_H, TILE_W, cap)
    tb = tr.Bins(_t(jb.ids), _t(jb.counts))
    rows64 = _rows64(js, n, seed)
    caps = {}
    if two_pass:
        n_over = int((np.asarray(jb.counts) > 128).sum())
        assert n_over >= 2
        # half the overfull tiles are hot: the rest render truncated lists,
        # so the hot-set choice (ties included) shows in the output
        caps = dict(cap_small=128, hot_k=max(1, n_over // 2))
    ids_j, z_j, pl_j = jrp.rasterize_interp_pallas(js, jb, rows64, W, H, TILE_H, TILE_W,
                                                   interpret=True, **caps)
    ids_t, z_t, pl_t = trc.rasterize_interp(ts, tb, _t(rows64), W, H, TILE_H, TILE_W, **caps)
    agree = _check_fold(ids_t, z_t, ids_j, z_j)
    pl_t, pl_j = pl_t.numpy(), np.asarray(pl_j)
    np.testing.assert_array_equal(pl_t[8:, agree], pl_j[8:, agree])
    np.testing.assert_allclose(pl_t[:8, agree], pl_j[:8, agree], rtol=1e-3, atol=1e-4)
    bg = ids_t.numpy() < 0
    assert (pl_t[:, bg] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_limits_hot_set_matches_top_k(seed):
    """Stable descending sort == lax.top_k (ties to the lower tile index)."""
    counts = np.random.default_rng(seed).integers(0, 6, 40).astype(np.int32) * 100
    cap, cap_small, hot_k = 512, 128, 7
    lim = trc.tile_limits(torch.as_tensor(counts), cap, cap_small, hot_k).numpy()
    c = np.minimum(counts, cap)
    _, hot = jax.lax.top_k(jnp.asarray(c), hot_k)
    want = np.minimum(c, cap_small)
    want[np.asarray(hot)] = c[np.asarray(hot)]
    np.testing.assert_array_equal(lim, want)


@pytest.mark.parametrize("cap,tiles", [(128, 16), (256, 100), (512, 16), (2048, 675),
                                       (8192, 675)])
def test_split_caps_and_rows_match(cap, tiles):
    assert trc.split_caps(cap, tiles) == jrp.split_caps(cap, tiles)


def test_pack_raster_rows_matches():
    js, ts, _ = _setups(300, 0)
    np.testing.assert_array_equal(trc.pack_raster_rows(ts).numpy(),
                                  np.asarray(jrp.pack_raster_rows(js)))


def test_pack_rows64_layout():
    """Raster row, payload, the AABB (poisoned for invalid triangles), pad."""
    _, ts, _ = _setups(300, 0)
    ts = ts._replace(valid=ts.valid & (torch.arange(300) % 7 != 0))
    payload = torch.as_tensor(np.random.default_rng(5).uniform(-1, 1, (300, 40)),
                              dtype=torch.float32)
    rows = trc.pack_rows64(ts, payload)
    assert rows.shape == (300, 64) and rows.dtype == torch.float32
    np.testing.assert_array_equal(rows[:, :16].numpy(), trc.pack_raster_rows(ts).numpy())
    np.testing.assert_array_equal(rows[:, 16:56].numpy(), payload.numpy())
    v = ts.valid.numpy()
    np.testing.assert_array_equal(rows[v, 56:60].numpy(), ts.aabb[v].numpy())
    assert (rows[~v, 56:60] == -3e38).all()
    assert (rows[:, 60:] == 0).all()


def test_rasterize_interp_rejects_unported_and_foreign_devices():
    """A device that is neither the CPU nor CUDA raises, planar or tiled
    (return_tiled is ported: test_rasterize_interp_tiled_matches_pallas)."""
    js, ts, _ = _setups(30, 0)
    tb = tr.bin_triangles(ts, H // TILE_H, W // TILE_W, TILE_H, TILE_W, 128)
    rows = torch.zeros((30, 64))
    for tiled in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            trc.rasterize_interp(ts, tb, rows.to("meta"), W, H, TILE_H, TILE_W,
                                 return_tiled=tiled)


def test_rasterize_interp_tiled_matches_pallas():
    """return_tiled=True: the TPU kernel's raw tile blocks (tiles, p, 24),
    (tiles, p, 1) ids and z (inf on background), next to the (H, W) images."""
    n, seed = 300, 0
    js, ts, _ = _setups(n, seed)
    jb = jr.bin_triangles(js, H // TILE_H, W // TILE_W, TILE_H, TILE_W, 128)
    tb = tr.Bins(_t(jb.ids), _t(jb.counts))
    rows64 = _rows64(js, n, seed)
    want = jrp.rasterize_interp_pallas(js, jb, rows64, W, H, TILE_H, TILE_W, interpret=True,
                                       return_tiled=True)
    got = trc.rasterize_interp(ts, tb, _t(rows64), W, H, TILE_H, TILE_W, return_tiled=True)
    agree = _check_fold(got[0], got[1], want[0], want[1])
    tiles = (H // TILE_H) * (W // TILE_W)
    p = TILE_H * TILE_W
    pl_t, id_t, z_t = (x.numpy() for x in got[2:])
    pl_j, id_j, z_j = (np.asarray(x) for x in want[2:])
    assert pl_t.shape == pl_j.shape == (tiles, p, 24)
    assert id_t.shape == z_t.shape == id_j.shape == (tiles, p, 1)
    agree_t = (id_t == id_j)[..., 0]
    np.testing.assert_array_equal(agree_t.sum(), agree.sum())
    np.testing.assert_array_equal(pl_t[agree_t][:, 8:], pl_j[agree_t][:, 8:])
    np.testing.assert_allclose(pl_t[agree_t][:, :8], pl_j[agree_t][:, :8], rtol=1e-3,
                               atol=1e-4)
    bg = id_t[..., 0] < 0
    assert bg.any() and np.isinf(z_t[bg]).all() and np.isinf(z_j[bg & agree_t]).all()
    np.testing.assert_allclose(z_t[~bg & agree_t], z_j[~bg & agree_t], atol=1e-4)


def test_exact_depth_ties_go_to_the_earliest_list_entry():
    """Every triangle drawn twice (ids k and k + n, identical): each covered
    pixel must keep the first copy, in the plain fold and in the kernel's
    plain version (two-pass split included)."""
    n = 300
    clip, tris = _scene(n, 0)
    tris2 = np.concatenate([np.asarray(tris), np.asarray(tris)])
    setup = tr.setup_triangles(_t(clip), _t(tris2), torch.ones(2 * n, dtype=torch.bool), W, H)
    bins = tr.bin_triangles(setup, H // TILE_H, W // TILE_W, TILE_H, TILE_W, 512)
    ids, _ = tr.rasterize(setup, bins, W, H, TILE_H, TILE_W)
    assert (ids >= 0).any() and (ids < n).all()
    rows64 = trc.pack_rows64(setup, torch.zeros((2 * n, 40)))
    ids_k, _, _ = trc.rasterize_interp(setup, bins, rows64, W, H, TILE_H, TILE_W,
                                       cap_small=128, hot_k=16)
    np.testing.assert_array_equal(ids_k.numpy(), ids.numpy())
