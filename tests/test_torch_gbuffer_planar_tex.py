"""The planar G-buffer's texture-cache and anisotropic branches
(`gbuffer._shade_from_interp` through `gbuffer_shade_planar`) against the
JAX package on the same interpolants (tests/test_torch_gbuffer_shading.py's
atlas and planes).

* `use_tex_kernel=True`: the taps go through `texcache.sample_atlas_textured`
  on the frame's own cache tiling (the plan with kernel B, which is kernel
  I at caps above 128, and kernel E, their plain versions here), trilinear,
  bilinear, with the LOD cascade and with caps above 128;
* `texture_filter="anisotropic"`: four trilinear taps along the major
  gradient, with and without use_tex_kernel (which only changes how the
  texture sizes are looked up).

Bars: GBufferA/B/C within 1 LSB of the RGBA8 quantization on almost every
texel equal (the module's bar in test_torch_gbuffer_shading.py), equal masks
and depth, and an equal `tex_approx` count (None on the anisotropic path).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import gbuffer as jgb
from direct12pbrrenderer_tpu_torch.ops import atlas_resolve_cuda, cover_cuda, gbuffer
from chip_smoke import recording
from test_torch_gbuffer_shading import _atlas, _check_gbuffer, _planes, _t

torch.set_num_threads(2)

CASES = {
    "trilinear": dict(texture_filter="trilinear", use_tex_kernel=True),
    "bilinear": dict(texture_filter="bilinear", use_tex_kernel=True),
    "cascade": dict(texture_filter="trilinear", use_tex_kernel=True,
                    tex_caps=(4, 4, None, (4, 4)), tex_cascade=(12, 8, 1)),
    "caps_above_128": dict(texture_filter="trilinear", use_tex_kernel=True,
                           tex_caps=(156, 44, None, (32, 16))),
    "aniso": dict(texture_filter="anisotropic", use_tex_kernel=False),
    "aniso_tex_kernel": dict(texture_filter="anisotropic", use_tex_kernel=True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_planar_gbuffer_branches_match_jax(case, seed):
    kw = CASES[case]
    jat, tat = _atlas()
    tri_id, depth, planes = _planes(seed)
    j = jgb.gbuffer_shade_planar(jnp.asarray(tri_id), jnp.asarray(depth), jnp.asarray(planes),
                                 jat, tex_interpret=True, **kw)
    with recording(atlas_resolve_cuda, "atlas_resolve") as resolves, \
            recording(cover_cuda, "fused_cover") as covers:
        t = gbuffer.gbuffer_shade_planar(_t(tri_id), _t(depth), _t(planes), tat, **kw)
    _check_gbuffer(t, j)
    cache = kw["use_tex_kernel"] and kw["texture_filter"] != "anisotropic"
    assert len(resolves) == cache
    # with caps above 128 the lo half's cover is kernel I (B's launch at
    # such a cap), the other covers are B's at caps up to 128
    wide = [c for c in covers if max(c[0][2]) > cover_cuda.WIDE_CAP]
    assert len(wide) == (case == "caps_above_128")
    if cache:
        assert int(t.tex_approx) == int(j.tex_approx)
        if case == "cascade":
            assert int(t.tex_approx) > 0      # the starved cover really overflowed
    else:
        assert t.tex_approx is None and j.tex_approx is None


def test_anisotropic_sampler_matches_jax():
    """The sampler alone, on slanted quads where the aniso ratio matters."""
    jat, tat = _atlas()
    rng = np.random.default_rng(4)
    h, w = 16, 24
    uv = rng.uniform(-0.5, 1.5, (h, w, 2)).astype(np.float32)
    ddx = (rng.normal(0, 0.05, (h, w, 2)) * [1.0, 0.1]).astype(np.float32)
    ddy = (rng.normal(0, 0.05, (h, w, 2)) * [0.1, 1.0]).astype(np.float32)
    tex = rng.integers(0, 2, (h, w, 5)).astype(np.int32)
    size5 = np.asarray(jat.base_size)[tex].astype(np.float32)
    mask = rng.random((h, w)) > 0.1
    want = jgb.sample_atlas_anisotropic(jat, jnp.asarray(tex), jnp.asarray(uv),
                                        jnp.asarray(ddx), jnp.asarray(ddy), jnp.asarray(size5),
                                        jnp.asarray(mask))
    got = gbuffer.sample_atlas_anisotropic(tat, _t(tex).long(), _t(uv), _t(ddx), _t(ddy),
                                           _t(size5), _t(mask))
    # four trilinear taps of float32 chains: ulp-level log2/pow differences
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_tap_lod_lookup_forms_agree():
    """The texture-size lookup of both forms (use_tex_kernel or not) is exact."""
    _, tat = _atlas()
    tri_id, _, planes = _planes(0)
    uv = _t(planes[0:2]).permute(1, 2, 0)
    tex = torch.clamp(_t(planes[19:24]).permute(1, 2, 0).long(), min=0)
    mask = _t(tri_id) >= 0
    a = gbuffer.tap_lod(uv, tex, mask, tat, use_tex_kernel=True)
    b = gbuffer.tap_lod(uv, tex, mask, tat, use_tex_kernel=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
