"""The port's tile-clustered point lights (`ops/lights_cuda.py`, kernel G's
plain version on the CPU) against the JAX package's `ops/lights_pallas.py`
in interpret mode, on the inputs of `tests/test_lights_pallas.py` (48x256,
two 24x128 tiles per row, identity view):

* `tile_light_lists`: ids and counts bit-equal with 40 and with 1024 light
  rows;
* `point_lights_kernel_reference` against the TPU kernel `_kernel` on the
  same staged inputs, in the "scattered" (130 of 256 rows, cap 256) and
  "capped" (64 frustum-covering lights of 128 rows: every cluster reaches
  its 32-light cap) scenarios: hit counters equal; rgb within rtol 1e-5 /
  atol 1e-6 on all but 0.5% of the values and within rtol 1e-3 / atol 1e-5
  on all of them; and `point_lights_tiled` against the JAX pass at the same
  bar. XLA's CPU backend contracts a*b+c into fused multiply-adds and
  approximates rsqrt, log and pow to within an ulp or two, which PyTorch
  does not; on glossy pixels (roughness about 0.1-0.3) the GGX term
  1 + n.h^2 (a^4 - 1) cancels and turns those ulps into relative errors of
  up to 7e-4 (measured here on 0.23% and 0.34% of the values);
* the port's tiled lights against its own dense sweep through
  `shading.deferred_shade`, at the JAX test's bar (rtol 5e-4 / atol 5e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import recording
from direct12pbrrenderer_tpu.ops import common as jcommon
from direct12pbrrenderer_tpu.ops import lights_pallas
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import common, lights_cuda, shading
from test_lights_pallas import FAR, FOV, H, NEAR, RATIO, TILE, W, _gbuffer, _light_rows

torch.set_num_threads(2)
TILES_Y, TILES_X = H // TILE[0], W // TILE[1]
SCENARIOS = {"scattered": (7, 130, 256, False), "capped": (8, 64, 128, True)}


def _scenario(name):
    """-> (rows (N, 14), (albedo_emission, oct, rough_metal_ao, depth, mask)
    numpy, light cap)."""
    seed, n, pool, covering = SCENARIOS[name]
    rng = np.random.default_rng(seed)
    gb = [np.array(x) for x in _gbuffer(rng)]
    rows = np.array(_light_rows(rng, n, pool, all_covering=covering))
    return rows, gb, pool


def _pass_inputs(gb):
    """The pass's per-pixel inputs from a G-buffer, numpy: (albedo, normal,
    roughness, metallic, z_view, mask)."""
    alb_em, oct_, rma, depth, mask = gb
    normal = np.array(jcommon.decode_octahedron(jnp.asarray(oct_)))
    z_view = (NEAR * FAR / (FAR - depth * (FAR - NEAR))).astype(np.float32)
    return alb_em[..., :3], normal, rma[..., 0], rma[..., 1], z_view, mask


@pytest.mark.parametrize("n_rows,cap", [(40, 128), (1024, 1024)])
def test_tile_light_lists_bit_equal(n_rows, cap):
    rows = np.array(_light_rows(np.random.default_rng(3), min(n_rows, 1000), n_rows))
    args = (TILES_Y, TILES_X, TILE[0], TILE[1], W, H, FOV, RATIO, NEAR, FAR, cap)
    want = jax.jit(lights_pallas.tile_light_lists, static_argnums=tuple(range(1, 12)))(
        jnp.asarray(rows), *args)
    got = lights_cuda.tile_light_lists(torch.as_tensor(rows), *args)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].max()) > (32 if n_rows > 40 else 0)


def _jax_kernel(counts, const, rows_t, gb_t, cap):
    """The TPU kernel `lights_pallas._kernel` in interpret mode, laid out as
    `point_lights_tiled` launches it."""
    n, p, _ = gb_t.shape
    kernel = functools.partial(lights_pallas._kernel, tile_h=TILE[0], tile_w=TILE[1],
                               tiles_x=TILES_X, cap=cap)
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(n,),
        in_specs=[pl.BlockSpec((1, 16, cap), lambda t, *_: (t, 0, 0)),
                  pl.BlockSpec((1, p, 12), lambda t, *_: (t, 0, 0))],
        out_specs=pl.BlockSpec((1, p, 4), lambda t, *_: (t, 0, 0)))
    return np.asarray(pl.pallas_call(
        kernel, grid_spec=spec, out_shape=jax.ShapeDtypeStruct((n, p, 4), jnp.float32),
        interpret=True)(*(jnp.asarray(x.numpy()) for x in (counts, const, rows_t, gb_t))))


def _assert_rgb_close(got, want):
    """rtol 1e-5 / atol 1e-6 on all but 0.5% of the values, rtol 1e-3 /
    atol 1e-5 on all (see the module docstring)."""
    loose = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert loose.mean() <= 5e-3, (loose.mean(), np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_point_lights_plain_matches_tpu_kernel(scenario):
    rows, gb, cap = _scenario(scenario)
    arrays = [torch.as_tensor(np.ascontiguousarray(a)) for a in _pass_inputs(gb)]
    launches = LAUNCHES["point_lights"]
    with recording(lights_cuda, "point_lights_kernel") as calls:
        rgb, counts = lights_cuda.point_lights_tiled(
            torch.as_tensor(rows), *arrays, torch.eye(4), torch.zeros(3), FOV, RATIO, NEAR, FAR,
            W, H, tile_h=TILE[0], tile_w=TILE[1], cap=cap)
    assert LAUNCHES["point_lights"] == launches  # CPU: the plain version
    (kargs, kw), = calls
    got = lights_cuda.point_lights_kernel_reference(*kargs, **kw).numpy()
    want = _jax_kernel(*kargs, cap)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])          # hit counters
    _assert_rgb_close(got[..., :3], want[..., :3])
    if scenario == "capped":
        mask = kargs[3][..., 9].numpy() > 0.5
        assert (got[..., 3][mask] == 32).all()
    else:
        assert 0 < got[..., 3].max() < 32

    # the whole pass against the JAX pass
    jrgb, jcounts = lights_pallas.point_lights_tiled(
        *(jnp.asarray(a) for a in (rows, *_pass_inputs(gb))), jnp.eye(4), jnp.zeros(3), FOV,
        RATIO, NEAR, FAR, W, H, tile_h=TILE[0], tile_w=TILE[1], cap=cap, interpret=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    _assert_rgb_close(rgb.numpy(), np.asarray(jrgb))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_tiled_lights_match_dense_sweep(scenario):
    rows, (alb_em, oct_, rma, depth, mask), cap = _scenario(scenario)
    t = torch.as_tensor
    sh = torch.zeros((7, 4))
    lut = (common.make_quad_tex2d(torch.zeros((8, 8, 2))), 8)
    cube = common.CubeMipAtlas.from_mips([torch.zeros((6, 8, 8, 3))], "cpu")

    def shade(light_tile):
        return shading.deferred_shade(
            t(alb_em), t(oct_), t(rma), t(depth), t(mask), sh, lut, cube, cube, t(rows),
            torch.eye(4), torch.zeros(3), FOV, RATIO, NEAR, FAR, W, H, light_tile=light_tile,
            light_cap=cap).numpy()

    np.testing.assert_allclose(shade(TILE), shade(None), rtol=5e-4, atol=5e-4)
