"""The port's `envcache.sample_env_tiled` (plan with kernel B's plain version,
resolve with kernel F's plain version `env_resolve_reference`, on the CPU)
against the JAX package's in interpret mode, on the inputs of
`tests/test_envcache.py`: the deferred pass's four tap groups of random
directions (row budget 8: part of the env taps overflow), one group under a
cap that overflows, and two groups under a generous and under a truncating
staging budget.

`covered` and `approx` must be bit-equal; rgba within rtol 1e-6 / atol 1e-7
(the same bf16 words and the same bilinear weights; only the association of
the blend may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import common as jcommon
from direct12pbrrenderer_tpu.ops import envcache as jenv
from direct12pbrrenderer_tpu_torch.ops import env_resolve_cuda, envcache

torch.set_num_threads(2)
H, W = 24, 128


def _chains(rng, size, n_mips, c=3):
    return [[rng.random((max(size >> m, 1), max(size >> m, 1), c)).astype(np.float32)
             for m in range(n_mips)] for _ in range(6)]


def _atlases(rng, env_size, env_mips, sky_size=8, lut_size=8):
    """The same float atlas from both packages' `FloatAtlasBuilder`, and its
    texture ids."""
    env, sky = _chains(rng, env_size, env_mips), _chains(rng, sky_size, 1)
    lut = rng.random((lut_size, lut_size, 2)).astype(np.float32)
    out = []
    for b in (envcache.FloatAtlasBuilder(), jenv.FloatAtlasBuilder()):
        ids = (b.add_cube(env), b.add_cube(sky), b.add([lut]))
        out.append(b)
    return out[0].build("cpu"), out[1].build(), ids


def _dirs(rng):
    d = rng.normal(size=(H, W, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    face, u, v = jcommon.cubemap_coords(jnp.asarray(d))
    return np.asarray(face), np.asarray(u), np.asarray(v)


def _case(name):
    """-> (torch atlas, jax atlas, (tex, mip, u, v, active) numpy (H, W, G),
    keyword arguments of both calls)."""
    if name == "four_groups":   # test_env_tiled_matches_xla_samplers
        rng = np.random.default_rng(5)
        ta, ja, (env_base, sky_base, lut_tid) = _atlases(rng, 16, 4)
        face_e, ue, ve = _dirs(rng)
        face_s, us, vs = _dirs(rng)
        rough = rng.random((H, W), dtype=np.float32)
        ndv = rng.random((H, W), dtype=np.float32)
        mask = rng.random((H, W)) > 0.4
        lvl = np.clip(rough * 5.0, 0.0, 3.0)
        lo = np.floor(lvl).astype(np.int32)
        hi = np.minimum(lo + 1, 3)
        zero = np.zeros((H, W), np.int32)
        stacks = (np.stack([env_base + face_e, env_base + face_e,
                            np.full((H, W), lut_tid, np.int32), sky_base + face_s], -1),
                  np.stack([lo, hi, zero, zero], -1), np.stack([ue, ue, rough, us], -1),
                  np.stack([ve, ve, ndv, vs], -1), np.stack([mask, mask, mask, ~mask], -1))
        env_t, sky_t = tuple(range(env_base, env_base + 6)), tuple(range(sky_base, sky_base + 6))
        kw = dict(fb_tids=(env_t, env_t, (lut_tid,), sky_t), share=((0, 1),), cap=40)
        return ta, ja, stacks, kw
    if name == "overflow":      # test_env_overflow_resolves_to_coarse_directional_fallback
        rng = np.random.default_rng(9)
        ta, ja, (env_base, _, _) = _atlases(rng, 64, 2)
        face, u, v = _dirs(rng)
        stacks = ((env_base + face)[..., None].astype(np.int32), np.zeros((H, W, 1), np.int32),
                  u[..., None], v[..., None], np.ones((H, W, 1), bool))
        return ta, ja, stacks, dict(fb_tids=(tuple(range(env_base, env_base + 6)),), cap=8)
    # the staging-budget cases (test_env_stage_budget_*)
    generous = name == "generous_budget"
    rng = np.random.default_rng(11 if generous else 13)
    ta, ja, (env_base, _, lut_tid) = _atlases(rng, 16 if generous else 64, 2)
    face, u, v = _dirs(rng)
    rough = rng.random((H, W), dtype=np.float32)
    ndv = rng.random((H, W), dtype=np.float32)
    zero = np.zeros((H, W), np.int32)
    stacks = (np.stack([env_base + face, np.full((H, W), lut_tid, np.int32)], -1),
              np.stack([zero, zero], -1), np.stack([u, rough], -1), np.stack([v, ndv], -1),
              np.ones((H, W, 2), bool))
    kw = dict(fb_tids=(tuple(range(env_base, env_base + 6)), (lut_tid,)), cap=(40, 8),
              block_cap=16, stage_budget=64 if generous else 16)
    return ta, ja, stacks, kw


@pytest.mark.parametrize("name", ["four_groups", "overflow", "generous_budget",
                                  "truncating_budget"])
def test_sample_env_tiled_matches_jax(name):
    ta, ja, stacks, kw = _case(name)
    want = jenv.sample_env_tiled(ja, *(jnp.asarray(a) for a in stacks), interpret=True, **kw)
    launches = env_resolve_cuda.env_resolve.launches
    got = envcache.sample_env_tiled(ta, *(torch.as_tensor(a) for a in stacks), **kw)
    assert env_resolve_cuda.env_resolve.launches == launches  # CPU: the plain version
    rgba, covered, approx = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1].numpy(), covered)
    np.testing.assert_array_equal(got[2].numpy(), approx)
    np.testing.assert_allclose(got[0].numpy(), rgba, rtol=1e-6, atol=1e-7)
    act = stacks[4]
    if name == "generous_budget":
        assert covered[act].all()             # every tap fits: all exact
    else:                                     # overflowing taps take the fallback
        assert approx.any() and (covered | approx)[act].all()
