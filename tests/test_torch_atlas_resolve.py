"""Kernel E, the planar texture-cache resolve (`atlas_resolve_cuda`, its
plain version on the CPU), through `texcache.sample_atlas_tiled` and
`sample_atlas_textured`, against the JAX package's functions of the same
names in interpret mode, on a stub atlas of random mip chains.

Trilinear (10 tap groups), bilinear (5) and the LOD cascade (15 groups, the
cascade mask and the per-tile flag) at a 24x128 cache tile, and a 128x36
frame whose 18x128 tile the JAX package pads to 24 rows (the port does not
pad; the padded rows are inactive and change nothing). The plan is the same
(`tests/test_torch_texcache.py` holds it bit-equal), so the covered and the
approx masks must be equal, and every tap's rgba is held to the JAX
package's own bar between its tiled and direct samplers (atol 1e-6,
tests/test_texcache.py): XLA's CPU backend contracts the bilinear blend into
multiply-adds, up to 2 ulp from the port's separately rounded products. The
port's covered taps are bit-equal to the port's direct-atlas sampler
(`gbuffer.sample_atlas_raw`): the cache is exact where it covers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import texcache as jtex
from direct12pbrrenderer_tpu_torch.ops import atlas_resolve_cuda, gbuffer, texcache
from test_torch_texcache import _atlases

torch.set_num_threads(2)
SPECS = [(64, 64, False), (32, 16, True), (128, 64, False)]


def _taps(rng, h, w):
    """(tex, u, v, lod, active) of a planar frame: row-coherent uv ramps with
    noise, random slots' textures, LODs and active taps."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = (xx / w * 1.4 - 0.2 + rng.random((h, w)) * 0.01).astype(np.float32)
    v = (yy / h * 1.1 + 0.1 + rng.random((h, w)) * 0.01).astype(np.float32)
    tex = rng.integers(0, 3, (h, w, 5)).astype(np.int32)
    lod = (0.5 + rng.random((h, w, 5)) * 1.5).astype(np.float32)
    act = rng.random((h, w, 5)) > 0.2
    return tex, u, v, lod, act


CASES = {
    "trilinear": (48, 256, dict(filter="trilinear")),
    "bilinear": (48, 256, dict(filter="bilinear")),
    # a starved primary cover so the cascade re-taps
    "cascade": (48, 256, dict(filter="trilinear", cap_lo=4, cap_hi=4, block_cap=(4, 4),
                              cascade=True, cascade_caps=(12, 8, 1))),
    # the JAX package pads this tile's 18 rows to 24
    "padded": (36, 128, dict(filter="trilinear")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_atlas_tiled_matches_jax(case):
    h, w, kw = CASES[case]
    rng = np.random.default_rng(29)
    jat, tat = _atlases(rng, SPECS)
    taps = _taps(rng, h, w)
    tile = texcache.pick_tile(h, w)
    assert tile == jtex.pick_tile(h, w)
    if case == "padded":
        assert tile == (18, 128)
    want = jtex.sample_atlas_tiled(jat, *(jnp.asarray(a) for a in taps), tile_h=tile[0],
                                   tile_w=tile[1], interpret=True, **kw)
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        mp.setattr(atlas_resolve_cuda, "atlas_resolve",
                   lambda *a, **k: calls.append(1) or atlas_resolve_cuda.atlas_resolve_reference(
                       *a, **k))
        got = texcache.sample_atlas_tiled(tat, *(torch.as_tensor(a) for a in taps),
                                          tile_h=tile[0], tile_w=tile[1], **kw)
    assert len(calls) == 1
    rgba_j, cov_j, approx_j = (np.asarray(x) for x in want)
    rgba, cov, approx = (x.numpy() for x in got)
    assert rgba.shape == rgba_j.shape == (h, w, 5, 4) and rgba.dtype == np.float32
    np.testing.assert_array_equal(cov, cov_j)
    np.testing.assert_array_equal(approx, approx_j)
    np.testing.assert_allclose(rgba, rgba_j, rtol=0, atol=1e-6)
    tex, u, v, lod, act = (torch.as_tensor(a) for a in taps)
    direct = gbuffer.sample_atlas_raw(tat, tex.long(), u[..., None], v[..., None], lod,
                                      kw["filter"]).numpy()
    np.testing.assert_array_equal(rgba[cov], direct[cov])
    act = taps[4]
    if case == "cascade":
        assert approx.any()                     # the starved cover really cascaded
    else:
        assert cov[act].mean() > 0.5


@pytest.mark.parametrize("filt", ["trilinear", "bilinear"])
def test_sample_atlas_textured_matches_jax(filt):
    rng = np.random.default_rng(31)
    jat, tat = _atlases(rng, SPECS)
    taps = _taps(rng, 48, 256)
    want = jtex.sample_atlas_textured(jat, *(jnp.asarray(a) for a in taps), filter=filt,
                                      interpret=True)
    got = texcache.sample_atlas_textured(tat, *(torch.as_tensor(a) for a in taps),
                                         filter=filt)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    a, b = got[0].numpy(), np.asarray(want[0])
    # the tiled bar above, through the sRGB EOTF's pow (slope <= 1 on the
    # taps' range, so a 1e-6 input difference stays within 1e-6 ... 2e-6)
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    assert np.isfinite(a).all()


def test_sample_atlas_textured_without_a_cache_tiling():
    """A frame that admits no cache tiling samples with the direct-atlas
    sampler and reports no approx taps (the JAX function's contract)."""
    rng = np.random.default_rng(37)
    jat, tat = _atlases(rng, SPECS)
    taps = _taps(rng, 7, 13)
    assert texcache.pick_tile(7, 13) is None
    want = jtex.sample_atlas_textured(jat, *(jnp.asarray(a) for a in taps), interpret=True)
    got = texcache.sample_atlas_textured(tat, *(torch.as_tensor(a) for a in taps))
    assert not got[1].any() and not np.asarray(want[1]).any()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)


def test_atlas_resolve_plain_version_is_kernel_c_tap_body():
    """E's plain version resolves each slot with kernel C's plain tap body."""
    rng = np.random.default_rng(43)
    _, tat = _atlases(rng, SPECS)
    tex, u, v, lod, act = (torch.as_tensor(a) for a in _taps(rng, 48, 256))
    tile_g = [texcache._tile(x.permute(2, 0, 1), 24, 128)
              for x in (tex, u[..., None].expand(tex.shape), v[..., None].expand(tex.shape),
                        lod, act)]
    plan = texcache._plan_and_stage(tat, *tile_g, trilinear=True, cap_lo=92, cap_hi=44,
                                    block_cap=16, stage_budget=None)
    off, cnts, staged, rec, fx, fy, tl = plan[:7]
    out = atlas_resolve_cuda.atlas_resolve(off, cnts, staged, rec, fx, fy, tl, trilinear=True)
    assert out.shape == (rec.shape[0], 5, 4, rec.shape[2], 128)
    from direct12pbrrenderer_tpu_torch.ops import resolve_shade_cuda
    for s in range(5):
        want = resolve_shade_cuda.resolve_slot(off, cnts, staged, rec, fx, fy, tl, None, s,
                                               True)
        assert torch.equal(out[:, s], torch.stack(want, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        atlas_resolve_cuda.atlas_resolve(off, cnts, staged, rec.to("meta"), fx, fy, tl,
                                         trilinear=True)
