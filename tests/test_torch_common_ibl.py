"""The port's ops/common.py and ops/ibl.py against the JAX package.

Same inputs, made with numpy from a fixed seed, go through both. Elementwise
float32 math agrees to rounding: the transcendental functions (pow, log2,
sqrt, sin/cos) of the two libraries may differ by an ulp or two, so the bar is
rtol 1e-5 / atol 1e-6 (about 80 ulp of headroom). The IBL precompute sums
1024 importance samples per texel in the same order and chunking on both
sides; per-sample ulp differences accumulate over the sum, which bounds the
LUT and the prefiltered mips at 2e-5 absolute (their values are O(1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import common as jc
from direct12pbrrenderer_tpu.ops import ibl as jibl
from direct12pbrrenderer_tpu_torch.ops import common as tc
from direct12pbrrenderer_tpu_torch.ops import ibl as tibl

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["decode_gamma", "encode_gamma", "srgb_eotf", "luminance"])
def test_transfer_functions(name):
    x = _rng(1).uniform(-0.2, 1.5, (64, 3)).astype(np.float32)
    _close(getattr(tc, name)(torch.as_tensor(x)), getattr(jc, name)(jnp.asarray(x)))


def test_octahedron_roundtrip_matches():
    d = _unit(_rng(2), (500,))
    enc_t = tc.encode_octahedron(torch.as_tensor(d))
    _close(enc_t, jc.encode_octahedron(jnp.asarray(d)))
    _close(tc.decode_octahedron(enc_t), jc.decode_octahedron(jnp.asarray(enc_t.numpy())))


def test_brdf_terms_match():
    rng = _rng(3)
    n, v, l = _unit(rng, (256,)), _unit(rng, (256,)), _unit(rng, (256,))
    albedo = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    metal = rng.uniform(0, 1, (256,)).astype(np.float32)
    rough = rng.uniform(0.05, 1, (256,)).astype(np.float32)
    t = tc.brdf(*(torch.as_tensor(a) for a in (albedo, metal, rough, n, v, l)))
    j = jc.brdf(*(jnp.asarray(a) for a in (albedo, metal, rough, n, v, l)))
    _close(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("roughness", [0.05, 0.5, 1.0])
def test_ggx_importance_sample_matches(roughness):
    rng = _rng(4)
    n = _unit(rng, (128,))
    n[:4] = [0, 0, 1]  # the up-vector switch at |n.z| >= 0.999
    xi = tc.hammersley(128)
    np.testing.assert_array_equal(xi, jc.hammersley(128))
    _close(tc.ggx_importance_sample(roughness, torch.as_tensor(n), torch.as_tensor(xi)),
           jc.ggx_importance_sample(roughness, jnp.asarray(n), jnp.asarray(xi)),
           atol=1e-5)


def test_frustum_cull_bit_equal():
    rng = _rng(5)
    planes = rng.normal(size=(6, 4)).astype(np.float32)
    mins = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    maxs = mins + rng.uniform(0, 3, (300, 3)).astype(np.float32)
    t = tc.frustum_cull_aabbs(*(torch.as_tensor(a) for a in (planes, mins, maxs)))
    j = jc.frustum_cull_aabbs(*(jnp.asarray(a) for a in (planes, mins, maxs)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_cubemap_addressing_matches():
    np.testing.assert_array_equal(tc.cubemap_face_dirs(8), jc.cubemap_face_dirs(8))
    d = _unit(_rng(6), (1000,))
    d[:6] = [[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1], [-1, 0, 0], [0, 0, -1]]  # ties
    ft, ut, vt = tc.cubemap_coords(torch.as_tensor(d))
    fj, uj, vj = jc.cubemap_coords(jnp.asarray(d))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    _close(ut, uj)
    _close(vt, vj)


def test_cube_atlas_and_quad_samplers_match():
    rng = _rng(7)
    mips = [rng.uniform(0, 4, (6, s, s, 3)).astype(np.float32) for s in (8, 4, 2)]
    dirs = _unit(rng, (400,))
    lvl = rng.uniform(-0.5, 3.0, (400,)).astype(np.float32)
    at = tc.CubeMipAtlas.from_mips(mips, "cpu")
    aj = jc.CubeMipAtlas([jnp.asarray(m) for m in mips])
    np.testing.assert_array_equal(at.flat.numpy(), np.asarray(aj.flat))
    _close(tc.sample_cube_atlas_trilinear(at, torch.as_tensor(dirs), torch.as_tensor(lvl)),
           jc.sample_cube_atlas_trilinear(aj, jnp.asarray(dirs), jnp.asarray(lvl)))
    _close(tc._cube_atlas_bilinear(at, torch.as_tensor(dirs), 0),
           jc._cube_atlas_bilinear(aj, jnp.asarray(dirs), jnp.int32(0)))
    _close(tc.sample_cubemap_trilinear([torch.as_tensor(m) for m in mips],
                                       torch.as_tensor(dirs), torch.as_tensor(lvl)),
           jc.sample_cubemap_trilinear([jnp.asarray(m) for m in mips], jnp.asarray(dirs),
                                       jnp.asarray(lvl)))

    tex = rng.uniform(0, 1, (6, 5, 2)).astype(np.float32)
    qt = tc.make_quad_tex2d(torch.as_tensor(tex))
    qj = jc.make_quad_tex2d(jnp.asarray(tex))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    u, v = rng.uniform(-0.1, 1.1, (2, 300)).astype(np.float32)
    _close(tc.sample_quad_tex2d(qt, 6, 5, torch.as_tensor(u), torch.as_tensor(v)),
           jc.sample_quad_tex2d(qj, 6, 5, jnp.asarray(u), jnp.asarray(v)))


def test_brdf_lut_matches_jax():
    _close(tibl.brdf_lut(size=32, device="cpu"), jibl.brdf_lut(size=32), rtol=0, atol=2e-5)


def test_brdf_lut_needs_a_device():
    """An entry point of the port runs where its caller says: no CPU default."""
    with pytest.raises(TypeError, match="device"):
        tibl.brdf_lut(size=8)


def test_prefilter_env_map_matches_jax():
    rng = _rng(8)
    base = rng.uniform(0, 2, (6, 16, 16, 3)).astype(np.float32)
    src_t = tibl.build_cubemap_mips(torch.as_tensor(base), 5)
    src_j = jibl.build_cubemap_mips(jnp.asarray(base), 5)
    for a, b in zip(src_t, src_j):
        _close(a, b)
    out_t = tibl.prefilter_env_map(src_t, out_size=16)
    out_j = jibl.prefilter_env_map(tuple(src_j), out_size=16)
    assert [tuple(m.shape) for m in out_t] == [tuple(m.shape) for m in out_j]
    for a, b in zip(out_t, out_j):
        _close(a, b, rtol=0, atol=2e-5)
