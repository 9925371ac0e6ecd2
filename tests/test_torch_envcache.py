"""The port's env page cache (builder and plan, kernel B's plain version on
the CPU) against the JAX package's `ops/envcache.py` in interpret mode.

* `pack_bf16`, `quantize_bf16` and `FloatAtlasBuilder.build()` bit-equal:
  both packages store the same packed bf16 pages and tables.
* `plan_env_tiled` bit-equal on every output (offsets, counts, staged pages,
  tap records, fracs, covered) for the deferred pass's tap groups with and
  without env content (the cascade group), and under a truncating budget.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import envcache as jenv
from direct12pbrrenderer_tpu.ops import shading as jshading
from direct12pbrrenderer_tpu_torch.ops import envcache, shading

torch.set_num_threads(2)


def _chains(rng, size, n_mips, c=3):
    return [[rng.random((max(size >> m, 1), max(size >> m, 1), c)).astype(np.float32)
             for m in range(n_mips)] for _ in range(6)]


def _build(builder_cls, rng_seed, env_size=16, env_mips=4, sky_size=8, lut_size=8):
    rng = np.random.default_rng(rng_seed)
    b = builder_cls()
    env_base = b.add_cube(_chains(rng, env_size, env_mips))
    sky_base = b.add_cube(_chains(rng, sky_size, 1))
    lut_tid = b.add([rng.random((lut_size, lut_size, 2)).astype(np.float32)])
    return b, (env_base, sky_base, lut_tid, env_mips)


def test_pack_and_quantize_bf16_match_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=(500, 16)) * 10.0 ** rng.integers(-30, 30, (500, 1)),
                        np.array([[0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 1e-40, 65504.0,
                                   1.00390625, 1.01171875, 2.0 ** -126, 0.1, 0.2, 0.3, 0.5,
                                   0.7]])], 0).astype(np.float32)
    np.testing.assert_array_equal(envcache.pack_bf16(x), jenv.pack_bf16(x))
    np.testing.assert_array_equal(envcache.quantize_bf16(x), jenv.quantize_bf16(x))


def test_float_atlas_builder_matches_jax():
    bt, ids_t = _build(envcache.FloatAtlasBuilder, 1, env_size=40)   # padded pages
    bj, ids_j = _build(jenv.FloatAtlasBuilder, 1, env_size=40)
    assert ids_t == ids_j
    got, want = bt.build("cpu"), bj.build()
    assert got._fields == want._fields
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(envcache.fused_table(got).numpy(),
                                  np.asarray(jenv.fused_table(want)))


def _tap_stacks(rng, env_ids, tiles=2, blocks=8):
    """The deferred pass's env tap groups for random view geometry, in the
    tiled layout both plans take: (tex, mip, u, v, act) (tiles, G, blocks,
    128), fb_tids, caps."""
    n = tiles * blocks * 128
    refl = rng.normal(size=(n, 3)).astype(np.float32)
    refl /= np.linalg.norm(refl, axis=-1, keepdims=True)
    # a mostly coherent view ray field: one direction plus a little noise
    ray = (np.array([0.3, 0.2, 1.0], np.float32) + 0.15 * rng.normal(size=(n, 3))).astype(
        np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    rough = (rng.random(n) * 0.6).astype(np.float32)
    ndv = rng.random(n).astype(np.float32)
    mask = rng.random(n) > 0.3
    out = jshading.env_tap_groups(jnp.asarray(refl), jnp.asarray(ray), jnp.asarray(rough),
                                  jnp.asarray(ndv), jnp.asarray(mask), env_ids)
    tex, mip, u, v, act, fb_tids, caps, _, _ = out
    g = tex.shape[-1]

    def tiled(x):
        return np.ascontiguousarray(np.asarray(x).reshape(tiles, blocks, 128, g)
                                    .transpose(0, 3, 1, 2))

    return [tiled(x) for x in (tex, mip, u, v, act)], fb_tids, caps


@pytest.mark.parametrize("case", ["env", "no_env", "budget"])
def test_plan_env_tiled_bit_equal(case):
    has_env = case != "no_env"
    bt, ids = _build(envcache.FloatAtlasBuilder, 2)
    bj, _ = _build(jenv.FloatAtlasBuilder, 2)
    env_ids = (*ids, has_env)
    stacks, fb_tids, caps = _tap_stacks(np.random.default_rng(3), env_ids)
    assert len(caps) == 4 + has_env
    budget = 8 * len(caps) + 16 if case == "budget" else None
    kw = dict(fb_tids=fb_tids, share=((0, 1),), caps=caps, block_cap=8, stage_budget=budget)
    want = jenv.plan_env_tiled(bj.build(), *(jnp.asarray(a) for a in stacks), interpret=True,
                               **kw)
    got = envcache.plan_env_tiled(bt.build("cpu"), *(torch.as_tensor(a) for a in stacks), **kw)
    names = ("off", "cnts", "staged", "rec", "fx", "fy", "covered")
    for w, g, name in zip(want, got, names):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    covered, act = got[6].numpy(), stacks[4]
    if case == "budget":          # the budget really truncated spans
        assert (act & ~covered).any()
    else:
        assert covered[act].mean() > 0.5


def test_env_tap_groups_match_jax():
    rng = np.random.default_rng(4)
    refl = rng.normal(size=(4, 64, 3)).astype(np.float32)
    ray = rng.normal(size=(4, 64, 3)).astype(np.float32)
    rough, ndv = rng.random((2, 4, 64)).astype(np.float32)
    mask = rng.random((4, 64)) > 0.5
    for env_ids in [(0, 6, 12, 5, True), (0, 6, 12, 5, False), (0, 6, 12, 3)]:
        want = jshading.env_tap_groups(jnp.asarray(refl), jnp.asarray(ray), jnp.asarray(rough),
                                       jnp.asarray(ndv), jnp.asarray(mask), env_ids)
        got = shading.env_tap_groups(torch.as_tensor(refl), torch.as_tensor(ray),
                                     torch.as_tensor(rough), torch.as_tensor(ndv),
                                     torch.as_tensor(mask), env_ids)
        for w, g in zip(want[:5], got[:5]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[5:7] == tuple(want[5:7]) and got[8] == want[8]
        np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[7]))
