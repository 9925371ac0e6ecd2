"""The env cache's plan from the deferred pass's per-pixel fields,
`envcache.env_plan`, on the CPU, where it runs its plain version:

* every output bit-equal to `shading.env_tap_groups` followed by
  `envcache.plan_env_tiled` on the same fields (the seven plan outputs, the
  fallback count env_approx, fracm and has_env), in both layouts the deferred
  passes hand it (the fused pass's tile blocks; the unfused pass's image cut
  into tiles, a 16x64 tile among them), with and without env content (5 or 4
  tap groups) and under a budget that truncates spans; no kernel launches;
* `resolve_untiled` over the image layout's plan gives `sample_env_tiled`'s
  rgba and covered;
* fields and budgets that no kernel takes raise.

The kernels themselves are held to this plain version on the card
(`tests/test_torch_env_plan_cuda.py`).
"""

import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import envcache, shading
from direct12pbrrenderer_tpu_torch.ops.texcache import _tile

torch.set_num_threads(2)

# layout -> (leading shape of the fields, tile: None for tile blocks)
LAYOUTS = {"blocks": ((3, 24, 128), None), "image24x128": ((48, 256), (24, 128)),
           "image16x64": ((32, 192), (16, 64))}


def _atlas(seed, env_mips=4):
    rng = np.random.default_rng(seed)
    b = envcache.FloatAtlasBuilder()

    def chains(size, n_mips):
        return [[rng.random((max(size >> m, 1), max(size >> m, 1), 3)).astype(np.float32)
                 for m in range(n_mips)] for _ in range(6)]

    env_base = b.add_cube(chains(40, env_mips))   # padded pages
    sky_base = b.add_cube(chains(8, 1))
    lut_tid = b.add([rng.random((8, 8, 2)).astype(np.float32)])
    return b.build("cpu"), (env_base, sky_base, lut_tid, env_mips)


def _fields(seed, lead):
    """refl, ray (lead, 3), roughness, n_dot_v (lead) and mask (lead): random
    reflections, a mostly coherent view ray field, a third of the pixels sky."""
    rng = np.random.default_rng(seed)
    refl = rng.normal(size=lead + (3,)).astype(np.float32)
    refl /= np.linalg.norm(refl, axis=-1, keepdims=True)
    ray = (np.array([0.3, 0.2, 1.0], np.float32) + 0.15 * rng.normal(size=lead + (3,)))
    ray = (ray / np.linalg.norm(ray, axis=-1, keepdims=True)).astype(np.float32)
    rough = (rng.random(lead) * 0.7).astype(np.float32)
    ndv = rng.random(lead).astype(np.float32)
    return [torch.from_numpy(x) for x in (refl, ray, rough, ndv, rng.random(lead) > 0.3)]


def _want(atlas, fields, env_ids, tile, budget):
    """env_tap_groups, its stacks tiled (tiles, G, blocks, 128), plan_env_tiled."""
    tex, mip, u, v, act, fb_tids, caps, fracm, has_env = shading.env_tap_groups(*fields, env_ids)

    def to_g(x):
        return x.permute(0, 3, 1, 2) if tile is None else _tile(x.permute(2, 0, 1), *tile)

    plan = envcache.plan_env_tiled(atlas, to_g(tex), to_g(mip), to_g(u), to_g(v), to_g(act),
                                   fb_tids=fb_tids, share=((0, 1),), caps=caps, block_cap=8,
                                   stage_budget=budget)
    return (*plan, (to_g(act) & ~plan[6]).sum().to(torch.int32), fracm, has_env), to_g(act)


@pytest.mark.parametrize("case", ["env", "no_env", "budget"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_env_plan_equals_tap_groups_and_plan(layout, case):
    lead, tile = LAYOUTS[layout]
    atlas, ids = _atlas(1)
    env_ids = (*ids, case != "no_env")
    fields = _fields(2, lead)
    n_groups = 4 + (case != "no_env")
    budget = 8 * n_groups + 16 if case == "budget" else None
    want, act = _want(atlas, fields, env_ids, tile, budget)
    launches = LAUNCHES["env_plan"]
    got = envcache.env_plan(atlas, *fields, env_ids, tile=tile, stage_budget=budget)
    assert LAUNCHES["env_plan"] == launches   # CPU: the plain version
    names = ("off", "cnts", "staged", "rec", "fx", "fy", "covered", "env_approx", "fracm")
    assert len(got) == len(names) + 1 and got[-1] == want[-1] == (case != "no_env")
    for g, w, name in zip(got, want, names):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    rec = got[3]
    assert rec.shape[1] == n_groups and rec.shape[2] * 128 == np.prod(lead) // rec.shape[0]
    covered = got[6]
    if case == "budget":          # the budget really truncated spans
        assert int(got[7]) > 0 and int(got[7]) == int((act & ~covered).sum())
    else:
        assert covered[act].float().mean() > 0.5


def test_resolve_untiled_is_sample_env_tiled():
    (h, w), tile = LAYOUTS["image16x64"]
    atlas, ids = _atlas(3)
    fields = _fields(4, (h, w))
    plan = envcache.env_plan(atlas, *fields, ids, tile=tile)
    rgba, covered = envcache.resolve_untiled(plan[:7], h, w, *tile)
    tex, mip, u, v, act, fb_tids, caps, _, _ = shading.env_tap_groups(*fields, ids)
    want = envcache.sample_env_tiled(atlas, tex, mip, u, v, act, fb_tids=fb_tids,
                                     share=((0, 1),), cap=caps, tile_h=tile[0],
                                     tile_w=tile[1])
    assert torch.equal(rgba, want[0]) and torch.equal(covered, want[1])
    assert int(plan[7]) == int(want[2].sum())


@pytest.mark.parametrize("bad", ["tile", "blocks", "budget"])
def test_env_plan_rejects_what_no_kernel_takes(bad):
    atlas, ids = _atlas(5)
    lead, tile, budget = (32, 192), (16, 64), None
    if bad == "tile":
        tile = (8, 24)         # 192 pixels: not whole 128-pixel rows
    elif bad == "blocks":
        lead, tile = (3, 24, 64), None
    else:
        budget = 36            # not a multiple of 8
    with pytest.raises(ValueError):
        envcache.env_plan(atlas, *_fields(6, lead), ids, tile=tile, stage_budget=budget)
