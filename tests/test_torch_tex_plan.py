"""The texture cache's plan from the taps' per-pixel fields,
`texcache.tex_plan`, on the CPU, where it runs its plain version
`tex_plan_reference`:

* in both layouts its callers hand it (the fused G-buffer's raster blocks;
  the planar sampler's (H, W, 5) taps cut into tiles, an 18-row tile among
  them), trilinear and bilinear, with the LOD cascade and under a budget
  that truncates spans: every output bit-equal to the plan as the port ran
  it before `tex_plan` (the fused path's tap setup inline in
  `shade_planes_fused`, the planar sampler's tiling, then `_plan_and_stage`,
  and the fallback count `(act & ~covered).sum()`); the traced counters
  equal; no kernel launches;
* through it, `shade_planes_fused` and `sample_atlas_tiled` give the
  G-buffer, fallback count and samples of that same route;
* fields, budgets, caps and tilings that no kernel takes raise.

The kernels themselves are held to this plain version on the card
(`tests/test_torch_tex_plan_cuda.py`).
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_raster_planes, stub_atlas
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import atlas_resolve_cuda, resolve_shade_cuda, texcache
from direct12pbrrenderer_tpu_torch.utils import trace

torch.set_num_threads(2)

# layout -> (frame height, width, tile)
LAYOUTS = {"fused": (48, 256, (24, 128)), "planar": (48, 256, (24, 128)),
           "planar_rows18": (36, 128, (18, 128))}
CASES = {
    "trilinear": dict(trilinear=True),
    "bilinear": dict(trilinear=False),
    # a starved primary cover, so the cascade re-taps
    "cascade": dict(cap_lo=4, cap_hi=4, block_cap=(4, 4), cascade=True,
                    cascade_caps=(12, 8, 1)),
    "budget": dict(stage_budget=88, block_cap=(24, 12)),
}
OUTPUTS = ("off", "cnts", "staged", "rec", "fx", "fy", "tl", "covered", "sel", "approx")


def _fields(layout, seed=3):
    """The plan's fields of `layout` (random content, texture ids 0..2)."""
    h, w, tile = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    if layout == "fused":
        return tuple(torch.as_tensor(x) for x in random_raster_planes(rng, h, w, *tile)), tile
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = (xx / w * 1.4 + rng.random((h, w)) * 0.01).astype(np.float32)
    v = (yy / h * 1.1 + rng.random((h, w)) * 0.01).astype(np.float32)
    tex = rng.integers(0, 3, (h, w, 5)).astype(np.int32)
    lod = (0.5 + rng.random((h, w, 5)) * 2.0).astype(np.float32)
    act = rng.random((h, w, 5)) > 0.2
    return tuple(torch.as_tensor(x) for x in (tex, u, v, lod, act)), tile


def _todays_taps(atlas, fields, tile):
    """The taps (tex, u, v, lod, act) in tiled layout (tiles, 5, blocks, 128)
    as the port set them up before `tex_plan`: shade_planes_fused's inline
    setup, or sample_atlas_tiled's tiling."""
    tile_h, tile_w = tile
    if len(fields) == 5:
        tex, u, v, lod, active = fields

        def tile_g(x):
            return texcache._tile(x.permute(2, 0, 1), tile_h, tile_w)

        return (tile_g(tex), tile_g(u[..., None].expand(tex.shape)),
                tile_g(v[..., None].expand(tex.shape)), tile_g(lod), tile_g(active))
    pl_tiles, id_tiles = fields
    n_tiles, p, _ = pl_tiles.shape
    blocks = p // 128
    planes_t = pl_tiles.reshape(n_tiles, blocks, 128, 24).permute(0, 3, 1, 2)
    mask_t = id_tiles.reshape(n_tiles, 1, blocks, 128) >= 0
    uv_t = torch.where(mask_t, planes_t[:, 0:2], 0.0)
    use_t = planes_t[:, 14:19] > 0.5
    tex_t = torch.clamp(planes_t[:, 19:24].to(torch.int32), min=0)
    act_t = use_t & mask_t
    ddx, ddy = texcache._quad_deltas(uv_t, tile_h, tile_w)
    size5 = texcache.onehot_lookup(atlas.base_size.float(), tex_t)
    gx_u = ddx[:, 0][:, None] * size5[..., 0]
    gx_v = ddx[:, 1][:, None] * size5[..., 1]
    gy_u = ddy[:, 0][:, None] * size5[..., 0]
    gy_v = ddy[:, 1][:, None] * size5[..., 1]
    rho2 = torch.maximum(gx_u * gx_u + gx_v * gx_v, gy_u * gy_u + gy_v * gy_v)
    lod_t = torch.where(mask_t, 0.5 * torch.log2(torch.clamp(rho2, min=1e-12)), 99.0)
    return (tex_t, uv_t[:, 0:1].expand(tex_t.shape), uv_t[:, 1:2].expand(tex_t.shape), lod_t,
            act_t)


def _todays_plan(atlas, fields, tile, kw):
    """`_plan_and_stage` on the taps as set up before `tex_plan`, and the
    fallback count. -> (outputs, act_t)."""
    taps = _todays_taps(atlas, fields, tile)
    caps = kw.get("cascade_caps", (20, 8, 3))
    plan = texcache._plan_and_stage(
        atlas, *taps, trilinear=kw.get("trilinear", True), cap_lo=kw.get("cap_lo", 92),
        cap_hi=kw.get("cap_hi", 44), block_cap=kw.get("block_cap", 16),
        stage_budget=kw.get("stage_budget"), cascade=kw.get("cascade", False),
        cap_casc=caps[0], block_cap_casc=caps[1], casc_mip=caps[2])
    return (*plan, (taps[4] & ~plan[7]).sum().to(torch.int32)), taps[4]


def _equal(got, want):
    assert len(got) == len(want) == len(OUTPUTS)
    for g, w, name in zip(got, want, OUTPUTS):
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tex_plan_is_todays_plan(layout, case):
    atlas = stub_atlas(np.random.default_rng(1), "cpu")
    fields, tile = _fields(layout)
    kw = CASES[case]
    want, act = _todays_plan(atlas, fields, tile, kw)
    launches = LAUNCHES["tex_plan"]
    counts = torch.zeros(len(trace.PLAN_COUNTERS), dtype=torch.int64)
    with trace.counting(counts):
        got = texcache.tex_plan(atlas, fields, tile, **kw)
    assert LAUNCHES["tex_plan"] == launches          # CPU: the plain version
    _equal(got, want)
    _equal(texcache.tex_plan_reference(atlas, fields, tile, **kw), want)
    n_groups = got[0].shape[1]
    assert n_groups == 5 * ((2 if kw.get("trilinear", True) else 1) + kw.get("cascade", False))
    taps = int(counts[trace.PLAN_COUNTERS.index("tex_taps")])
    pages = int(counts[trace.PLAN_COUNTERS.index("tex_pages_staged")])
    assert (taps, pages) == (int(act.sum()), int(got[1][:, :n_groups].sum())) and taps > 0
    approx = int(got[9])
    if case in ("cascade", "budget"):   # the starved cover or the budget left taps over
        assert approx > 0 and approx == int((act & ~got[7]).sum())
        assert case != "cascade" or (got[8].any() and got[1][:, -1].any())
    else:
        assert got[7][act].float().mean() > 0.5


@pytest.mark.parametrize("case", ["trilinear", "bilinear", "cascade", "budget"])
def test_shade_planes_fused_is_todays(case):
    """The fused G-buffer through `tex_plan`: the G-buffer and fallback count
    of the route before it (its inline tap setup, `_plan_and_stage`, kernel
    C's plain version)."""
    atlas = stub_atlas(np.random.default_rng(1), "cpu")
    fields, tile = _fields("fused")
    kw = CASES[case]
    filt = {"filter": "trilinear" if kw.get("trilinear", True) else "bilinear"}
    plan_kw = {k: v for k, v in kw.items() if k != "trilinear"}
    (h, w, _), (pl_tiles, id_tiles) = LAYOUTS["fused"], fields
    got, got_approx = texcache.shade_planes_fused(atlas, pl_tiles, id_tiles, h, w, *tile,
                                                  **filt, **plan_kw)
    plan, _ = _todays_plan(atlas, fields, tile, kw)
    off, cnts, staged, rec, fx, fy, tl, _, sel, approx = plan
    n_tiles, p, _ = pl_tiles.shape
    planes_t = pl_tiles.reshape(n_tiles, p // 128, 128, 24).permute(0, 3, 1, 2)
    mask_t = id_tiles.reshape(n_tiles, 1, p // 128, 128) >= 0
    tex_t = torch.clamp(planes_t[:, 19:24].to(torch.int32), min=0)
    srgb5 = texcache.onehot_lookup(atlas.srgb.float()[:, None], tex_t)[..., 0] > 0.5
    flags = torch.cat([srgb5, mask_t], 1).to(torch.int32)
    gb = resolve_shade_cuda.resolve_shade(off, cnts, staged, rec, fx, fy, tl,
                                          planes_t[:, 2:19], flags, sel,
                                          trilinear=kw.get("trilinear", True))
    assert torch.equal(got, texcache._untile(gb, h, w, *tile))
    assert got_approx.dtype == torch.int32 and int(got_approx) == int(approx)


@pytest.mark.parametrize("case", ["trilinear", "bilinear", "cascade"])
def test_sample_atlas_tiled_is_todays(case):
    """The planar sampler through `tex_plan`: the samples, covered and approx
    masks of the route before it (its tiling, `_plan_and_stage`, kernel E's
    plain version)."""
    atlas = stub_atlas(np.random.default_rng(1), "cpu")
    fields, tile = _fields("planar")
    kw = CASES[case]
    filt = "trilinear" if kw.get("trilinear", True) else "bilinear"
    plan_kw = {k: v for k, v in kw.items() if k != "trilinear"}
    rgba, covered, approx = texcache.sample_atlas_tiled(
        atlas, *fields, filter=filt, tile_h=tile[0], tile_w=tile[1], **plan_kw)
    plan, _ = _todays_plan(atlas, fields, tile, kw)
    out = atlas_resolve_cuda.atlas_resolve(*plan[:7], plan[8], trilinear=filt == "trilinear")
    h, w = fields[1].shape
    assert torch.equal(rgba, texcache._untile(out, h, w, *tile).permute(2, 3, 0, 1))
    want_cov = texcache._untile(plan[7], h, w, *tile).permute(1, 2, 0)
    assert torch.equal(covered, want_cov) and torch.equal(approx, fields[4] & ~want_cov)


@pytest.mark.parametrize("bad", ["budget", "caps", "fused_tile", "planar_tile"])
def test_tex_plan_rejects_what_no_kernel_takes(bad):
    atlas = stub_atlas(np.random.default_rng(1), "cpu")
    layout = "planar" if bad == "planar_tile" else "fused"
    fields, tile = _fields(layout)
    kw = {}
    if bad == "budget":
        kw["stage_budget"] = 36          # not a multiple of 8
    elif bad == "caps":
        kw["cap_lo"] = 90                # 90 + 4 fallback pages: not a multiple of 8
    elif bad == "fused_tile":
        tile = (48, 64)                  # the fused blocks need tiles 128k wide
    else:
        tile = (8, 24)                   # 192 pixels: not whole 128-pixel rows
    with pytest.raises(ValueError):
        texcache.tex_plan(atlas, fields, tile, **kw)
