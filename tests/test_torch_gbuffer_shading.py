"""The port's G-buffer, clustered-light, deferred-shading, bloom and post
stages against the JAX package on the same numpy inputs (fixed seeds).

Bars: float32 elementwise chains agree to about 1e-6 relative (ulp-level
differences in pow/log2/sqrt between the libraries); the deferred HDR output
is held to 1e-5 relative on 99% of its values and to 1e-4 relative
everywhere, for ill-conditioned specular peaks (see
test_deferred_shade_matches). Anything quantized to RGBA8 (the G-buffer and the
tone-mapped image) may land one 1/255 step apart when an ulp difference
straddles a rounding boundary: at most 1 LSB, and almost every texel equal.
The bloom pyramid is float32 matrix products whose sums the two libraries
block differently: rtol 1e-5 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import bloom as jbloom
from direct12pbrrenderer_tpu.ops import clustered as jcl
from direct12pbrrenderer_tpu.ops import common as jc
from direct12pbrrenderer_tpu.ops import gbuffer as jgb
from direct12pbrrenderer_tpu.ops import ibl as jibl
from direct12pbrrenderer_tpu.ops import postprocess as jpp
from direct12pbrrenderer_tpu.ops import shading as jsh
from direct12pbrrenderer_tpu.pipeline.scene_pack import _AtlasBuilder
from direct12pbrrenderer_tpu.resource.formats import ETextureFormat
from direct12pbrrenderer_tpu.resource.storage import TextureData
from direct12pbrrenderer_tpu.scene.camera import Camera
from direct12pbrrenderer_tpu_torch.ops import bloom as tbloom
from direct12pbrrenderer_tpu_torch.ops import clustered as tcl
from direct12pbrrenderer_tpu_torch.ops import common as tc
from direct12pbrrenderer_tpu_torch.ops import gbuffer as tgb
from direct12pbrrenderer_tpu_torch.ops import postprocess as tpp
from direct12pbrrenderer_tpu_torch.ops import shading as tsh

torch.set_num_threads(2)
H, W = 32, 48
LSB = 1.0 / 255.0 + 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


def _atlas():
    """Two textures: sRGB 64x32 and linear 16x16, full mip chains."""
    rng = np.random.default_rng(0)
    b = _AtlasBuilder(max_dim=64)
    b.add(TextureData.from_array(rng.integers(0, 256, (32, 64, 4), dtype=np.uint8),
                                 ETextureFormat.R8G8B8A8_UNORM_SRGB))
    b.add(TextureData.from_array(rng.integers(0, 256, (16, 16, 4), dtype=np.uint8),
                                 ETextureFormat.R8G8B8A8_UNORM))
    a = b.build()
    jat = jgb.AtlasDevice(*(jnp.asarray(x) for x in (a.data, a.page_base, a.base_size,
                                                      a.n_mips, a.srgb)))
    tat = tgb.AtlasDevice.from_numpy(a.data, a.page_base, a.base_size, a.n_mips, a.srgb,
                                     device="cpu")
    return jat, tat


def _planes(seed):
    rng = np.random.default_rng(seed)
    tri_id = rng.integers(-1, 50, (H, W)).astype(np.int32)
    depth = rng.uniform(0.5, 1.0, (H, W)).astype(np.float32)
    # smooth uv so quad derivatives give a spread of LODs, plus noise
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    uv = np.stack([xx * 0.05 + 0.3 * np.sin(yy), yy * 0.11 - 1.3], 0)
    uv += rng.normal(0, 0.02, uv.shape)
    nrm = rng.normal(size=(3, H, W))
    tan = rng.normal(size=(3, H, W))
    mat = np.concatenate([
        rng.uniform(0, 1, (3, H, W)), rng.uniform(0, 2, (1, H, W)),
        rng.uniform(0, 1, (2, H, W)), rng.integers(0, 2, (5, H, W)),
        rng.integers(0, 2, (5, H, W))])
    planes = np.concatenate([uv, nrm, tan, mat]).astype(np.float32)
    return tri_id, depth, planes


def _check_gbuffer(t, j):
    for name in ("albedo_emission", "normal_oct", "rough_metal_ao"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        d = np.abs(a - b)
        assert d.max() <= LSB, (name, d.max())
        assert (d == 0).mean() > 0.99, (name, (d > 0).sum())
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.depth.numpy(), np.asarray(j.depth))


@pytest.mark.parametrize("filt", ["trilinear", "bilinear"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gbuffer_shade_planar_matches(seed, filt):
    jat, tat = _atlas()
    tri_id, depth, planes = _planes(seed)
    j = jgb.gbuffer_shade_planar(jnp.asarray(tri_id), jnp.asarray(depth), jnp.asarray(planes),
                                 jat, filt, use_tex_kernel=False)
    t = tgb.gbuffer_shade_planar(_t(tri_id), _t(depth), _t(planes), tat, filt)
    _check_gbuffer(t, j)


def test_gbuffer_shade_gather_path_matches():
    jat, tat = _atlas()
    rng = np.random.default_rng(2)
    tri_id, depth, planes = _planes(2)
    rows = np.zeros((50, 64), np.float32)
    rows[:, :9] = rng.normal(0, 0.05, (50, 9))
    rows[:, 2::3][:, :3] += 0.5
    rows[:, 16:32] = planes[8:24, :2].reshape(16, -1)[:, :50].T
    rows[:, 32:56] = rng.normal(0, 1, (50, 24))
    j = jgb.gbuffer_shade(jnp.asarray(tri_id), jnp.asarray(depth), jnp.asarray(rows), jat, W, H)
    t = tgb.gbuffer_shade(_t(tri_id), _t(depth), _t(rows), tat, W, H)
    _check_gbuffer(t, j)


def _lights(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    col = rng.uniform(0.2, 1, (n, 3)).astype(np.float32)
    inten = rng.uniform(1, 30, n).astype(np.float32)
    att = np.concatenate([rng.uniform(1, 5, (n, 1)), np.ones((n, 1)),
                          rng.uniform(0, 0.5, (n, 2))], 1).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7
    return pos, col, inten, att, valid


def _camera():
    cam = Camera(1.0, W, H, 0.1, 100.0)
    cam.move([0.5, 1.0, 6.0])
    cam.rotate(0, np.pi, 0.1)
    return cam


@pytest.mark.parametrize("max_active", [4, 32])
def test_build_active_lights_matches(max_active):
    args = _lights(20, 3)
    view = _camera().view_matrix().astype(np.float32)
    j = jcl.build_active_lights(*(jnp.asarray(a) for a in args), jnp.asarray(view), max_active)
    t = tcl.build_active_lights(*(_t(a) for a in args), _t(view), max_active)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tcl.cluster_bounds(1.0, 1.5, 0.1, 100.0),
                                  jcl.cluster_bounds(1.0, 1.5, 0.1, 100.0))


def test_deferred_shade_matches():
    rng = np.random.default_rng(4)
    q = lambda x: (np.round(x * 255) / 255).astype(np.float32)  # noqa: E731
    gb_a = q(rng.uniform(0, 1, (H, W, 4)))
    gb_b = q(rng.uniform(0, 1, (H, W, 2)))
    gb_c = q(rng.uniform(0, 1, (H, W, 3)))
    depth = rng.uniform(0.95, 0.9999, (H, W)).astype(np.float32)
    mask = rng.uniform(size=(H, W)) < 0.8
    sh = rng.normal(0, 0.3, (7, 4)).astype(np.float32)
    lut = np.asarray(jibl.brdf_lut(size=16))
    pf = [rng.uniform(0, 3, (6, 16 >> m, 16 >> m, 3)).astype(np.float32) for m in range(5)]
    sky = rng.uniform(0, 3, (6, 8, 8, 3)).astype(np.float32)
    cam = _camera()
    view = cam.view_matrix().astype(np.float32)
    inv_view = cam.world_matrix().astype(np.float32)
    pos = np.asarray(cam.position, np.float32)
    lights = np.asarray(jcl.build_active_lights(
        *(jnp.asarray(a) for a in _lights(12, 5)), jnp.asarray(view), 16))
    scal = (1.0, W / H, 0.1, 100.0)
    j = jsh.deferred_shade(
        *(jnp.asarray(a) for a in (gb_a, gb_b, gb_c, depth, mask, sh)),
        (jc.make_quad_tex2d(jnp.asarray(lut)), 16),
        jc.CubeMipAtlas([jnp.asarray(m) for m in pf]), jc.CubeMipAtlas([jnp.asarray(sky)]),
        jnp.asarray(lights), jnp.asarray(inv_view), jnp.asarray(pos), *scal, W, H)
    t = tsh.deferred_shade(
        *(_t(a) for a in (gb_a, gb_b, gb_c, depth, mask, sh)),
        (tc.make_quad_tex2d(_t(lut)), 16),
        tc.CubeMipAtlas.from_mips(pf, "cpu"), tc.CubeMipAtlas.from_mips([sky], "cpu"),
        _t(lights), _t(inv_view), _t(pos), *scal, W, H)
    t, j = t.numpy(), np.asarray(j)
    # near-zero roughness makes GGX's D = a^2 / (pi t^2), t = 1 - n.h^2 (1 - a^2),
    # cancel: there an ulp of the half-vector grows to ~1e-4 relative
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5)
    assert np.isclose(t, j, rtol=1e-5, atol=1e-6).mean() > 0.99


@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
def test_bloom_matches(hw):
    rng = np.random.default_rng(6)
    hdr = (rng.uniform(0, 1, hw + (3,)) ** 4 * 6).astype(np.float32)
    np.testing.assert_allclose(tbloom.bloom(_t(hdr)).numpy(), np.asarray(jbloom.bloom(
        jnp.asarray(hdr))), rtol=1e-5, atol=1e-5)


def test_postprocess_matches():
    rng = np.random.default_rng(7)
    hdr = (rng.uniform(0, 1, (H, W, 3)) ** 3 * 4).astype(np.float32)
    hdr[:3] = 0.0  # black pixels -> bin 0
    ht, hj = _t(hdr), jnp.asarray(hdr)
    np.testing.assert_array_equal(tpp.luminance_bins(ht).numpy(), np.asarray(jpp.luminance_bins(hj)))
    hist_t = tpp.luminance_histogram(ht)
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(jpp.luminance_histogram(hj)))
    prev, dt = np.float32(0.3), np.float32(1 / 60)
    a_t = tpp.average_luminance_direct(ht, float(H * W), torch.tensor(prev), torch.tensor(dt))
    a_j = jpp.average_luminance_direct(hj, float(H * W), jnp.asarray(prev), jnp.asarray(dt))
    np.testing.assert_allclose(float(a_t), float(a_j), rtol=1e-6)
    h_t = tpp.average_luminance(hist_t, float(H * W), torch.tensor(prev), torch.tensor(dt))
    np.testing.assert_allclose(float(h_t), float(a_j), rtol=1e-6)
    tm_t = tpp.tone_map(ht, a_t).numpy()
    tm_j = np.asarray(jpp.tone_map(hj, a_j))
    assert np.abs(tm_t - tm_j).max() <= LSB
    assert (tm_t == tm_j).mean() > 0.99
