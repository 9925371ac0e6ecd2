"""The port's texture-cache plan and kernels B and C (their plain versions,
on the CPU) against the JAX package's `ops/texcache.py` in interpret mode.

* Kernel B's plain version (`cover_cuda.fused_cover`) against
  `texcache._fused_cover_pallas`: bit-equal on all four outputs (list,
  count, slot, covered) for sparse, adversarial (more distinct pages per row
  than block_cap), empty-group and per-group-cap content.
* `_plan_and_stage`: every output bit-equal (offsets, counts, staged pages,
  tap records, fracs, covered, cascade mask) for trilinear, bilinear, the
  LOD cascade and a truncating stage budget.
* `shade_planes_fused` (plan + kernel C) against the JAX fused G-buffer with
  the JAX package's bar (test_texcache.py): every channel within 1.01/255,
  at most 2e-3 of values differing, and the same fallback-tap count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import gbuffer as jgbuffer
from direct12pbrrenderer_tpu.ops import texcache as jtex
from direct12pbrrenderer_tpu.pipeline import scene_pack
from direct12pbrrenderer_tpu_torch.ops import cover_cuda, gbuffer, texcache
from test_texcache import _StubTexture

torch.set_num_threads(2)


def _atlases(rng, specs):
    """The same atlas for both packages: (JAX AtlasDevice, port AtlasDevice)."""
    builder = scene_pack._AtlasBuilder()
    for w, h, srgb in specs:
        builder.add(_StubTexture(rng, w, h, srgb))
    a = builder.build()
    fields = (a.data, a.page_base, a.base_size, a.n_mips, a.srgb)
    return (jgbuffer.AtlasDevice(*(jnp.asarray(f) for f in fields)),
            gbuffer.AtlasDevice.from_numpy(*fields, device="cpu"))


def _cover_case(name):
    rng = np.random.default_rng(31)
    tiles, g, blocks = 3, 3, 8
    pages = np.zeros((tiles, g, blocks, 128), np.int32)
    act = np.zeros((tiles, g, blocks, 128), bool)
    if name == "sparse":              # 1-3 distinct pages per row
        pages[:] = rng.integers(0, 3, pages.shape)
        act[:] = rng.random(act.shape) > 0.1
        return pages, act, (16, 16, 16), 4
    if name == "adversarial":         # far more distinct pages per row than block_cap
        pages[:] = rng.integers(0, 1000, pages.shape)
        act[:] = True
        return pages, act, (16, 16, 16), 4
    if name == "empty_group":         # an all-inactive tile and an all-inactive group
        pages[:] = rng.integers(0, 40, pages.shape)
        act[:] = rng.random(act.shape) > 0.5
        act[0] = False
        act[1, 2] = False
        return pages, act, (16, 16, 16), 4
    # per-group caps below the realized demand: counts clamp, slots saturate
    pages[:] = rng.integers(0, 25, pages.shape)
    act[:] = rng.random(act.shape) > 0.3
    return pages, act, (16, 8, 4), 4


@pytest.mark.parametrize("name", ["sparse", "adversarial", "empty_group", "per_group_caps"])
def test_cover_plain_version_matches_tpu_kernel(name):
    pages, act, caps, block_cap = _cover_case(name)
    want = jtex._fused_cover_pallas(jnp.asarray(pages), jnp.asarray(act), caps, block_cap,
                                    max(caps), interpret=True)
    got = cover_cuda.fused_cover(torch.as_tensor(pages), torch.as_tensor(act), caps, block_cap)
    cap_max = max(caps)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0])[..., :cap_max], "list")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1])[..., 0], "count")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]), "slot")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]) != 0, "covered")
    if name == "adversarial":
        assert not got[3].all()       # the row budget really overflowed
    if name == "per_group_caps":
        assert (got[1].numpy() == np.asarray(caps)).any()  # a count clamped to its cap


def _plan_inputs(rng, tiles=2, blocks=8):
    shape = (tiles, 5, blocks, 128)
    tex = rng.integers(0, 3, shape).astype(np.int32)
    # row-coherent uv ramps (real frames) with some noise
    x = np.arange(blocks * 128, dtype=np.float32).reshape(blocks, 128) / (blocks * 128)
    u = np.broadcast_to(0.1 + 1.3 * x, shape) + rng.random(shape, np.float32) * 0.02
    v = np.broadcast_to(0.2 + 0.05 * np.arange(blocks, dtype=np.float32)[:, None],
                        shape) + rng.random(shape, np.float32) * 0.02
    lod = rng.random(shape, np.float32) * 4.0
    act = rng.random(shape) > 0.2
    return [np.ascontiguousarray(a) for a in (tex, u, v, lod, act)]


PLAN_CASES = {
    "trilinear": dict(trilinear=True, cap_lo=92, cap_hi=44, block_cap=16, stage_budget=None),
    "bilinear": dict(trilinear=False, cap_lo=92, cap_hi=44, block_cap=16, stage_budget=None),
    "cascade": dict(trilinear=True, cap_lo=4, cap_hi=4, block_cap=(4, 4), stage_budget=None,
                    cascade=True, cap_casc=12, block_cap_casc=4, casc_mip=3),
    "budget": dict(trilinear=True, cap_lo=92, cap_hi=44, block_cap=(8, 4), stage_budget=96),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_and_stage_bit_equal(case):
    rng = np.random.default_rng(17)
    jat, tat = _atlases(rng, [(64, 64, False), (32, 16, True), (128, 64, False)])
    inputs = _plan_inputs(rng)
    kw = PLAN_CASES[case]
    want = jtex._plan_and_stage(jat, *(jnp.asarray(a) for a in inputs), interpret=True, **kw)
    got = texcache._plan_and_stage(tat, *(torch.as_tensor(a) for a in inputs), **kw)
    names = ("off", "cnts", "staged", "rec", "fx", "fy", "tl", "covered", "sel")
    for w, g, name in zip(want, got, names):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    covered = got[7].numpy()
    act = inputs[4]
    if case == "budget":                     # the budget really truncated spans
        assert (act & ~covered).any()
    if case == "cascade":                    # the starved cover really cascaded
        assert got[8].numpy().any()
    if case in ("trilinear", "bilinear"):
        assert covered[act].mean() > 0.5


def _raster_planes(rng, h, w):
    """The fused G-buffer's inputs (test_texcache.py's synthetic raster
    planes): smooth uv ramps, random normals/tangents, random material rows,
    15% background."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = np.stack([xx / w * 1.5 - 0.2 + rng.random((h, w)) * 0.01,
                   yy / h * 1.2 + rng.random((h, w)) * 0.01], 0)
    nrm = rng.normal(size=(3, h, w))
    tan = rng.normal(size=(3, h, w))
    mat = np.zeros((16, h, w))
    mat[0:6] = rng.random((6, h, w))                          # albedo, emission, rough, metal
    mat[6:11] = rng.random((5, h, w)) > 0.4                   # use
    mat[11:16] = rng.integers(0, 3, (5, h, w))                # tex ids
    planes = np.concatenate([uv, nrm, tan, mat], 0).astype(np.float32)
    tri_id = np.where(rng.random((h, w)) > 0.15, 1, -1).astype(np.int32)
    return planes, tri_id


def _to_tiles(x, th, tw):
    """(C, H, W) -> (tiles, p, C): the raster kernel's tile blocks."""
    c, h, w = x.shape
    return np.ascontiguousarray(
        x.reshape(c, h // th, th, w // tw, tw).transpose(1, 3, 2, 4, 0)
        .reshape(-1, th * tw, c))


@pytest.mark.parametrize("filt", ["trilinear", "bilinear"])
def test_shade_planes_fused_matches_jax(filt):
    rng = np.random.default_rng(23)
    h, w, th, tw = 48, 256, 24, 128
    jat, tat = _atlases(rng, [(32, 16, True), (16, 16, False), (8, 8, False)])
    planes, tri_id = _raster_planes(rng, h, w)
    pl_tiles = _to_tiles(planes, th, tw)
    id_tiles = _to_tiles(tri_id[None], th, tw)
    want, want_approx = jtex.shade_planes_fused(
        jat, jnp.asarray(pl_tiles), jnp.asarray(id_tiles), h, w, th, tw, filter=filt,
        interpret=True)
    got, got_approx = texcache.shade_planes_fused(
        tat, torch.as_tensor(pl_tiles), torch.as_tensor(id_tiles), h, w, th, tw, filter=filt)
    a, b = np.asarray(want), got.numpy()
    assert a.shape == b.shape == (9, h, w)
    assert np.abs(a - b).max() <= 1.01 / 255.0
    assert (np.abs(a - b) > 1e-6).mean() < 2e-3
    assert int(got_approx) == int(want_approx)
    assert (b[:, tri_id < 0] == 0).all() and b[:3, tri_id >= 0].any()


def test_tiling_helpers_match_jax():
    rng = np.random.default_rng(3)
    img = rng.random((2, 3, 48, 256)).astype(np.float32)
    tiled = texcache._tile(torch.as_tensor(img), 24, 128)
    want = np.asarray(jtex._tile(jnp.asarray(img), 24, 128, 24))
    np.testing.assert_array_equal(tiled.numpy(), want)
    np.testing.assert_array_equal(texcache._untile(tiled, 48, 256, 24, 128).numpy(), img)
    for hw in [(1080, 1920), (192, 256), (960, 1440), (7, 13), (96, 256), (720, 1280)]:
        assert texcache.pick_tile(*hw) == jtex.pick_tile(*hw)


def test_tables_and_mip_plan_match_jax():
    rng = np.random.default_rng(5)
    jat, tat = _atlases(rng, [(64, 64, False), (32, 16, True), (1, 1, False)])
    np.testing.assert_array_equal(texcache.fused_tex_table(tat).numpy(),
                                  np.asarray(jtex.fused_tex_table(jat)))
    tex = rng.integers(0, 4, (6, 40)).astype(np.int32)      # 3 is past the table
    lod = (rng.random((6, 40)) * 14 - 1).astype(np.float32)
    u, v = (rng.random((2, 6, 40)) * 6 - 3).astype(np.float32)
    for tri in (True, False):
        want = jtex._mip_plan(jat, jnp.asarray(tex), jnp.asarray(lod), tri)
        got = texcache._mip_plan(tat, torch.as_tensor(tex), torch.as_tensor(lod), tri)
        for w_, g_ in zip(want[:4], got[:4]):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        for w_, g_ in zip(want[4], got[4]):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
        m = got[4][-1]
        page = texcache._tap_addresses(got[0], got[1], texcache.select_mip(got[2], m), m,
                                       torch.as_tensor(u), torch.as_tensor(v))
        mj = want[4][-1]
        page_j = jtex._tap_addresses(want[0], want[1], jtex.select_mip(want[2], mj), mj,
                                     jnp.asarray(u), jnp.asarray(v))
        for w_, g_ in zip(page_j, page):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
