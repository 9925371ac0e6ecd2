"""Kernel H, the depth-only raster (`raster_cuda.rasterize_depth`, its plain
version on the CPU), against the JAX package's `raster_pallas.rasterize_pallas`
in interpret mode, on the JAX raster tests' random-triangle scenes.

Both fold the same bin lists with the same list limits (the two-pass split
included) and the same tie rule, and are held to the JAX package's own bar
between its two rasterizers (tests/test_raster_pallas.py): winners equal on
all but 1e-4 of the pixels, depths within 1e-4 where they agree. XLA's CPU
backend evaluates the interpret-mode kernel's edge and depth sums in another
order (contracted multiply-adds): on these scenes its `raster.rasterize` and
`rasterize_pallas` differ from each other by up to 4.6e-5 in depth, the
port's fold differs from either by as much, and one pixel of 49,152 (seed 1)
flips its winner where two triangles meet at equal depth. On the card the
kernel is held to this plain version bit for bit
(tests/test_torch_raster_depth_cuda.py).
`stages.rasterize` takes the kernel with `use_pallas=True` and the plain
fold over the whole lists without; where every overfull tile is hot, the two
agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import raster as jr
from direct12pbrrenderer_tpu.ops import raster_pallas as jrp
from direct12pbrrenderer_tpu_torch.ops import raster as tr
from direct12pbrrenderer_tpu_torch.ops import raster_cuda as trc
from direct12pbrrenderer_tpu_torch.pipeline import stages
from test_raster_pallas import _scene

torch.set_num_threads(2)
W, H, TILE_H, TILE_W = 256, 192, 24, 128


def _t(x):
    return torch.as_tensor(np.array(x))


def _case(n, seed, cap):
    clip, tris = _scene(n, seed)
    js = jr.setup_triangles(clip, tris, jnp.ones(tris.shape[0], bool), W, H)
    jb = jr.bin_triangles(js, H // TILE_H, W // TILE_W, TILE_H, TILE_W, cap)
    ts = tr.TriangleSetup(*(_t(a) for a in js))
    return js, jb, ts, tr.Bins(_t(jb.ids), _t(jb.counts))


def _overfull(jb):
    n_over = int((np.asarray(jb.counts) > 128).sum())
    assert n_over >= 2
    return n_over


@pytest.mark.parametrize("n,seed,cap,split", [
    (300, 0, 128, None), (300, 1, 128, None), (5, 0, 256, None),
    (2500, 3, 512, "all_hot"), (2500, 3, 512, "half_hot"), (2500, 3, 512, "auto")])
def test_rasterize_depth_matches_pallas(n, seed, cap, split):
    js, jb, ts, tb = _case(n, seed, cap)
    caps = {}
    if split == "all_hot":
        caps = dict(cap_small=128, hot_k=_overfull(jb))
    elif split == "half_hot":
        # half the overfull tiles are hot: the rest fold truncated lists, so
        # the hot-set choice (ties to the lower tile index) shows
        caps = dict(cap_small=128, hot_k=max(1, _overfull(jb) // 2))
    ids_j, z_j = jrp.rasterize_pallas(js, jb, W, H, TILE_H, TILE_W, interpret=True, **caps)
    ids_t, z_t = trc.rasterize_depth(ts, tb, W, H, TILE_H, TILE_W, **caps)
    assert ids_t.dtype == torch.int32 and z_t.dtype == torch.float32
    agree = ids_t.numpy() == np.asarray(ids_j)
    assert (~agree).mean() < 1e-4, f"{(~agree).sum()} id mismatches"
    np.testing.assert_allclose(z_t.numpy()[agree], np.asarray(z_j)[agree], rtol=0, atol=1e-4)
    assert (ids_t >= 0).any() and (z_t[ids_t < 0] == 1.0).all()
    if split == "half_hot":   # the truncation really shows
        full, _ = tr.rasterize(ts, tb, W, H, TILE_H, TILE_W)
        assert (full != ids_t).any()


def test_rasterize_depth_is_the_interp_kernels_fold():
    """H and kernel A fold the same lists to the same ids and depths."""
    js, jb, ts, tb = _case(2500, 3, 512)
    caps = dict(cap_small=128, hot_k=3)
    rows64 = trc.pack_rows64(ts, torch.zeros((2500, 40)))
    ids_a, z_a, _ = trc.rasterize_interp(ts, tb, rows64, W, H, TILE_H, TILE_W, **caps)
    ids_h, z_h = trc.rasterize_depth(ts, tb, W, H, TILE_H, TILE_W, **caps)
    assert torch.equal(ids_a, ids_h) and torch.equal(z_a, z_h)


@pytest.mark.parametrize("y_offset", [0, 48])
def test_stages_rasterize_both_paths(y_offset):
    """stages.rasterize: the kernel path (use_pallas, every overfull tile hot
    through raster_caps) equals the plain fold over the whole lists."""
    js, jb, ts, tb = _case(2500, 3, 512)
    if y_offset:
        tb = tr.bin_triangles(ts, H // TILE_H, W // TILE_W, TILE_H, TILE_W, 512,
                              y_offset=y_offset)
    n_over = int((tb.counts > 128).sum())
    caps = (128, max(n_over, 1))
    ids_k, z_k = stages.rasterize(ts, tb, W, H, TILE_H, TILE_W, True, y_offset=y_offset,
                                  raster_caps=caps)
    ids_p, z_p = stages.rasterize(ts, tb, W, H, TILE_H, TILE_W, False, y_offset=y_offset)
    assert torch.equal(ids_k, ids_p) and torch.equal(z_k, z_p)
    assert (ids_p >= 0).any()


def test_rasterize_depth_rejects_foreign_devices():
    _, _, ts, tb = _case(30, 0, 128)
    meta = tr.TriangleSetup(*(x.to("meta") for x in ts))
    with pytest.raises(ValueError, match="unsupported device"):
        trc.rasterize_depth(meta, tb, W, H, TILE_H, TILE_W)
