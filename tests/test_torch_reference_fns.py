"""The port's counterparts of the JAX package's reference-only functions
against the JAX package: the literal bloom chain, the per-cluster light
lists, the barycentrics, the 2D bilinear sampler, the env prefilter from a
cube-map texture and the mathlib helpers. No frame runs them; each is the
spec or the transcription that the JAX package keeps beside its fast path.

Inputs are made with numpy from fixed seeds and go through both packages.
Bars:
* mathlib: `np.array_equal` (the same numpy code on both sides);
* `pack_pixel_data`, `build_cluster_light_params`: bit-equal (copies and
  gathers);
* `barycentrics_at` and `barycentrics_from_packed`: bit-equal to each other
  (the same products and sums on the same values), and within rtol 1e-5 /
  atol 1e-6 of the JAX package (XLA may contract the edge score's
  multiply-adds);
* `sample_texture2d_bilinear`: the same texel indices and fractions; the
  four-term blend within rtol 1e-6 / atol 1e-6 of JAX's (contraction, on
  values in [0, 1]);
* `blur_h`, `blur_v`, `bloom_reference`: rtol/atol 2e-5, the bar of the
  JAX package's own fused-vs-literal test (`tests/test_postprocess.py`),
  which also holds the port's `bloom` to the port's `bloom_reference`;
* `cull_lights_to_clusters`: lists and counts equal, or at most max(1, 1e-4
  of clusters x lights) differing (cluster, light) decisions: XLA's CPU
  backend may contract the distance sum, and a one-ulp change at an AABB
  face moves one decision (the bar of tests/test_torch_lights_clusters.py);
* `cluster_index_image`: at most max(1, 1e-4 of the pixels) differ (XLA's
  CPU log is approximate; a one-ulp change at a slice edge moves a pixel);
* `prefilter_env_map_from_texture`: atol 2e-5, the bar of the prefilter in
  tests/test_torch_common_ibl.py (1024 samples summed in the same order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import bloom as jbloom
from direct12pbrrenderer_tpu.ops import clustered as jcl
from direct12pbrrenderer_tpu.ops import common as jc
from direct12pbrrenderer_tpu.ops import ibl as jibl
from direct12pbrrenderer_tpu.ops import raster as jr
from direct12pbrrenderer_tpu.utils import mathlib as jml
from direct12pbrrenderer_tpu_torch.ops import bloom as tbloom
from direct12pbrrenderer_tpu_torch.ops import clustered as tcl
from direct12pbrrenderer_tpu_torch.ops import common as tc
from direct12pbrrenderer_tpu_torch.ops import ibl as tibl
from direct12pbrrenderer_tpu_torch.ops import raster as tr
from direct12pbrrenderer_tpu_torch.resource.formats import ETextureFormat
from direct12pbrrenderer_tpu_torch.resource.storage import CubeMapTextureData, TextureData
from direct12pbrrenderer_tpu_torch.utils import mathlib as tml
from chip_smoke import cluster_members
from test_raster_pallas import _scene

torch.set_num_threads(2)
BLOOM_BAR = 2e-5
BARY_RTOL, BARY_ATOL = 1e-5, 1e-6
SAMPLER_RTOL, SAMPLER_ATOL = 1e-6, 1e-6
DECISION_FRAC = 1e-4


def _t(x):
    return torch.as_tensor(np.array(x))


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
        return True
    assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)
    return True


# ---------------------------------------------------------------- mathlib --

def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


MATHLIB_CASES = {
    "Rad2Deg": lambda ml, rng: ml.Rad2Deg,
    "projection_matrix0": lambda ml, rng: ml.projection_matrix0(1.1, 16 / 9, 0.1, 500.0),
    "frustum_contains_aabb": lambda ml, rng: tuple(
        ml.frustum_contains_aabb(
            ml.frustum_planes_from_matrix(
                ml.projection_matrix1(1.0, 1.5, 0.1, 100.0)),
            c - e, c + e)
        for c, e in zip(rng.uniform(-60, 60, (64, 3)).astype(np.float32),
                        rng.uniform(0.1, 8, (64, 3)).astype(np.float32))),
    "from_spherical": lambda ml, rng: tuple(
        ml.from_spherical(float(t), float(p))
        for t, p in rng.uniform(-4, 4, (16, 2))),
    "cubemap_direction": lambda ml, rng: tuple(
        ml.cubemap_direction(f, float(u), float(v))
        for f in range(6) for u, v in rng.uniform(0, 1, (4, 2))),
    "cubemap_direction_signed": lambda ml, rng: tuple(
        ml.cubemap_direction_signed(f, float(u), float(v))
        for f in range(6) for u, v in rng.uniform(-1, 1, (4, 2))),
    "cubemap_coordinate": lambda ml, rng: tuple(
        ml.cubemap_coordinate(d) for d in _unit(rng, 64)),
    "_nz_sign": lambda ml, rng: ml._nz_sign(
        np.concatenate([rng.normal(size=32), [0.0, -0.0]]).astype(np.float32)),
    "encode_octahedron": lambda ml, rng: ml.encode_octahedron(_unit(rng, 256)),
    "decode_octahedron": lambda ml, rng: ml.decode_octahedron(
        rng.uniform(0, 1, (256, 2)).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(MATHLIB_CASES))
def test_mathlib_matches_jax(name):
    case = MATHLIB_CASES[name]
    _equal(case(tml, np.random.default_rng(5)), case(jml, np.random.default_rng(5)))


def test_mathlib_aabb_matches_jax():
    """AABB's methods, with `transformed`'s two-corner quirk (MathLib.cpp:5-10)."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(-5, 5, (12, 3)).astype(np.float32)
    m = tml.compose_trs([1.0, -2.0, 3.0], [30.0, 45.0, -60.0], [1.0, 2.0, 0.5])
    out = []
    for ml in (tml, jml):
        box, other = ml.AABB(), ml.AABB(pts[0], pts[0] + 1.0)
        for p in pts:
            box.extend(p)
        t = box.transformed(m)
        u = box.union(other)
        out.append((box.min, box.max, box.center(), box.extents(), t.min, t.max, u.min,
                    u.max, np.asarray(box.contains(other)), np.asarray(other.contains(box)),
                    repr(box)))
    _equal(*out)
    # the quirk: the transformed box spans only the two transformed corners
    corners = np.stack([tml.transform_point(m, out[0][0]), tml.transform_point(m, out[0][1])])
    np.testing.assert_array_equal(out[0][4], corners.min(0).astype(np.float32))


# ---------------------------------------------------------------- sampler --

@pytest.mark.parametrize("wrap", [True, False])
def test_sample_texture2d_bilinear_matches_jax(wrap):
    rng = np.random.default_rng(7)
    tex = rng.uniform(0, 1, (37, 53, 4)).astype(np.float32)
    # uv well outside [0, 1]: negative texel indices exercise remainder's sign
    u = rng.uniform(-1.7, 2.6, (48, 40)).astype(np.float32)
    v = rng.uniform(-2.3, 1.9, (48, 40)).astype(np.float32)
    got = tc.sample_texture2d_bilinear(_t(tex), _t(u), _t(v), wrap=wrap).numpy()
    want = np.asarray(jc.sample_texture2d_bilinear(jnp.asarray(tex), jnp.asarray(u),
                                                   jnp.asarray(v), wrap=wrap))
    np.testing.assert_allclose(got, want, rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)
    assert got.shape == (48, 40, 4)


# ----------------------------------------------------------- barycentrics --

def _edge_on_quad():
    """tests/test_raster.py's perspective quad: vertex w 1, 4 and 2."""
    v = np.array([[-0.5, -0.5, 0.2, 1.0], [0.5, 0.5, 0.8, 4.0], [0.5, -0.5, 0.5, 2.0]],
                 np.float32)
    v[:, :3] *= v[:, 3:]
    tri_id = np.zeros(9, np.int32)
    px, py = np.meshgrid(np.float32([24.5, 32.0, 40.5]), np.float32([24.5, 32.0, 40.5]))
    return v, np.array([[0, 1, 2]], np.int32), tri_id, px.ravel(), py.ravel()


def _random_batch():
    clip, tris = _scene(300, 0)
    rng = np.random.default_rng(3)
    tri_id = rng.integers(0, tris.shape[0], 4096).astype(np.int32)
    px = (rng.integers(0, 256, 4096) + 0.5).astype(np.float32)
    py = (rng.integers(0, 192, 4096) + 0.5).astype(np.float32)
    return np.asarray(clip), np.asarray(tris), tri_id, px, py


@pytest.mark.parametrize("case", ["edge_on_quad", "random"])
def test_barycentrics_match_jax(case):
    clip, tris, tri_id, px, py = _edge_on_quad() if case == "edge_on_quad" else _random_batch()
    w, h = (64, 64) if case == "edge_on_quad" else (256, 192)
    js = jr.setup_triangles(jnp.asarray(clip), jnp.asarray(tris),
                            jnp.ones(tris.shape[0], bool), w, h)
    ts = tr.TriangleSetup(*(_t(a) for a in js))
    packed = tr.pack_pixel_data(ts)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jr.pack_pixel_data(js)))
    at = tr.barycentrics_at(ts, _t(tri_id), _t(px), _t(py))
    from_packed = tr.barycentrics_from_packed(packed, _t(tri_id), _t(px), _t(py))
    want = jr.barycentrics_at(js, jnp.asarray(tri_id), jnp.asarray(px), jnp.asarray(py))
    want_p = jr.barycentrics_from_packed(jr.pack_pixel_data(js), jnp.asarray(tri_id),
                                         jnp.asarray(px), jnp.asarray(py))
    for a, b, j, jp in zip(at, from_packed, want, want_p):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=BARY_RTOL, atol=BARY_ATOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(jp), rtol=BARY_RTOL, atol=BARY_ATOL)
    if case == "edge_on_quad":   # tests/test_raster.py's checks, on the port
        lam, lam_p, _ = (x.numpy() for x in at)
        np.testing.assert_allclose(lam.sum(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(lam_p.sum(-1), 1.0, atol=1e-5)
        assert np.abs(lam - lam_p).max() > 0.05
        assert (lam_p[:, 0] > lam[:, 0]).all()


# ------------------------------------------------------------------ bloom --

def _hdr(h=96, w=128, seed=11):
    return (np.random.default_rng(seed).random((h, w, 3)) * 12.0).astype(np.float32)


@pytest.mark.parametrize("name", ["blur_h", "blur_v"])
def test_blur_matches_jax(name):
    img = _hdr(37, 29, 3)
    got = getattr(tbloom, name)(_t(img)).numpy()
    want = np.asarray(getattr(jbloom, name)(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=BLOOM_BAR, atol=BLOOM_BAR)


def test_bloom_reference_matches_jax_and_the_port_bloom():
    img = _hdr()
    literal = tbloom.bloom_reference(_t(img))
    np.testing.assert_allclose(literal.numpy(), np.asarray(jbloom.bloom_reference(
        jnp.asarray(img))), rtol=BLOOM_BAR, atol=BLOOM_BAR)
    # the port's matrix bloom re-associates this chain (the JAX test's check)
    np.testing.assert_allclose(tbloom.bloom(_t(img)).numpy(), literal.numpy(),
                               rtol=BLOOM_BAR, atol=BLOOM_BAR)


# -------------------------------------------------------------- clustered --

FOV, RATIO, NEAR, FAR = math.pi / 3.0, 16 / 9, 0.1, 100.0


def _lights(n, seed):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-40, 40, n), rng.uniform(-5, 20, n),
                    rng.uniform(-60, 40, n)], -1).astype(np.float32)
    att = np.stack([rng.uniform(1, 12, n), np.ones(n), rng.uniform(0, 0.2, n),
                    rng.uniform(0, 0.05, n)], -1).astype(np.float32)
    return {"pos": pos, "radius": att[:, 0].copy(), "att": att,
            "intensity": rng.uniform(0.1, 4.0, n).astype(np.float32),
            "color": rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "valid": rng.random(n) < 0.9}


def _view():
    m = tml.compose_trs([3.0, 6.0, 18.0], [20.0, 180.0, 0.0], [1.0, 1.0, 1.0])
    return tml.quick_inverse(m)


@pytest.mark.parametrize("n,seed", [(300, 1), (96, 2)])
def test_cull_lights_to_clusters_matches_jax(n, seed):
    bounds = tcl.cluster_bounds(FOV, RATIO, NEAR, FAR)
    np.testing.assert_array_equal(bounds, jcl.cluster_bounds(FOV, RATIO, NEAR, FAR))
    lt, view = _lights(n, seed), _view()
    args = (bounds, view, lt["pos"], lt["radius"], lt["intensity"], lt["valid"])
    lists, counts = tcl.cull_lights_to_clusters(*(_t(a) for a in args))
    jlists, jcounts = jcl.cull_lights_to_clusters(*(jnp.asarray(a) for a in args))
    assert lists.dtype == counts.dtype == torch.int32 and tuple(lists.shape) == (3072, 32)
    differ = int((cluster_members(lists, n) != cluster_members(_t(jlists), n)).sum())
    bar = max(1, int(DECISION_FRAC * bounds.shape[0] * n))
    print(f"cull_lights_to_clusters: {differ} of {bounds.shape[0] * n} (cluster, light) "
          f"decisions differ from JAX's (bar {bar}); {int(counts.sum())} listed")
    assert differ <= bar
    if differ == 0:
        np.testing.assert_array_equal(lists.numpy(), np.asarray(jlists))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    else:
        assert int(np.abs(counts.numpy() - np.asarray(jcounts)).sum()) <= differ
    # the lists do real work: some clusters list lights, some hit the cap
    assert int(counts.sum()) > 0
    # lists are the hits in light index order, -1 padded after `counts`
    ls = lists.numpy()
    for c in np.flatnonzero(counts.numpy())[:64]:
        k = int(counts[c])
        assert (np.diff(ls[c, :k]) > 0).all() and (ls[c, k:] == -1).all()
    # build_cluster_light_params on JAX's lists: gathers, bit for bit
    params = tcl.build_cluster_light_params(_t(jlists), _t(lt["pos"]), _t(lt["color"]),
                                            _t(lt["intensity"]), _t(lt["att"]))
    jparams = jcl.build_cluster_light_params(jlists, jnp.asarray(lt["pos"]),
                                             jnp.asarray(lt["color"]),
                                             jnp.asarray(lt["intensity"]),
                                             jnp.asarray(lt["att"]))
    assert tuple(params.shape) == (3072, 32, 12)
    np.testing.assert_array_equal(params.numpy(), np.asarray(jparams))


def test_cull_lights_to_clusters_caps_each_list_at_32():
    """Lights that cover the whole frustum fill every cluster's 32 slots
    with lights 0-31; the count stops at 32."""
    bounds = tcl.cluster_bounds(FOV, RATIO, NEAR, FAR)
    n = 40
    pos = np.zeros((n, 3), np.float32)
    args = (bounds, np.eye(4, dtype=np.float32), pos, np.full(n, 200.0, np.float32),
            np.ones(n, np.float32), np.ones(n, bool))
    lists, counts = tcl.cull_lights_to_clusters(*(_t(a) for a in args))
    assert (counts.numpy() == 32).all()
    assert (lists.numpy() == np.arange(32, dtype=np.int32)[None, :]).all()


def test_cluster_index_image_matches_jax():
    rng = np.random.default_rng(4)
    uv_x = rng.uniform(-0.05, 1.05, (64, 96)).astype(np.float32)
    uv_y = rng.uniform(-0.05, 1.05, (64, 96)).astype(np.float32)
    z = np.exp(rng.uniform(np.log(0.05), np.log(150.0), (64, 96))).astype(np.float32)
    got = tcl.cluster_index_image(_t(uv_x), _t(uv_y), _t(z), NEAR, FAR)
    want = np.asarray(jcl.cluster_index_image(jnp.asarray(uv_x), jnp.asarray(uv_y),
                                              jnp.asarray(z), NEAR, FAR))
    assert got.dtype == torch.int32
    differ = int((got.numpy() != want).sum())
    assert differ <= max(1, int(DECISION_FRAC * z.size)), differ
    assert got.min() >= 0 and got.max() < tcl.NUM_CLUSTERS


# -------------------------------------------------------------------- ibl --

def _cubemap(size=16, seed=8):
    rng = np.random.default_rng(seed)
    faces = [TextureData.from_array(
        np.concatenate([rng.uniform(0, 2, (size, size, 3)), np.ones((size, size, 1))],
                       -1).astype(np.float32), ETextureFormat.R32G32B32A32_FLOAT)
        for _ in range(6)]
    return CubeMapTextureData(faces=faces)


def test_prefilter_env_map_from_texture_matches_jax():
    cube = _cubemap()
    got = tibl.prefilter_env_map_from_texture(cube, out_size=16, device="cpu")
    want = jibl.prefilter_env_map_from_texture(cube, out_size=16)
    assert [m.shape for m in got] == [m.shape for m in want]
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


def test_prefilter_env_map_from_texture_needs_a_device():
    """An entry point of the port runs where its caller says: no CPU default."""
    with pytest.raises(TypeError, match="device"):
        tibl.prefilter_env_map_from_texture(_cubemap(4), out_size=4)
