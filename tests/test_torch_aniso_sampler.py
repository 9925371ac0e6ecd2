"""The anisotropic sampler's wrapper (`ops/aniso_cuda.aniso_sample`) on the
CPU, where it runs its plain version, and the anisotropic branch of the
G-buffer that calls it:

* at the active (covered pixel, used slot) pairs the wrapper equals
  `gbuffer.sample_atlas_anisotropic` on the quad derivatives and texture
  sizes that `gbuffer.tap_lod` takes, bit for bit, and it is 0 at every
  other pair; it launches nothing;
* `gbuffer_shade_planar`'s anisotropic G-buffer is bit-equal to the one of
  the route before the wrapper (`tap_lod` first, then the sampler at every
  pair), with either texture-size lookup of `tap_lod`;
* the wrapper's checks of a CUDA call refuse odd frames and wrong shapes
  or types.

The synthetic frame (`synthetic_frame`, shared with the card test
`tests/test_torch_aniso_sampler_cuda.py`) has five textures of different
sizes and mip counts, sRGB and linear, all five slots used at many pixels,
uv outside [0, 1] on both sides, footprints above the ratio cap 4 along
either axis, isotropic ones with rx2 == ry2, zero gradients, and background
pixels; `census` says how many active pairs fall in each case.
"""

import numpy as np
import pytest
import torch

from chip_smoke import stub_atlas
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import aniso_cuda, gbuffer

torch.set_num_threads(2)

H, W = 32, 48
# (width, height, sRGB) of each texture: mip counts 7, 5, 4, 6, 8
SPECS = ((64, 32, True), (16, 16, False), (8, 4, True), (32, 32, True), (128, 128, False))
SEEDS = (0, 1)


def synthetic_frame(seed: int, device="cpu"):
    """(atlas, tri_id (H, W) int32, depth (H, W), planes (24, H, W)) of a
    frame whose quads are built from a corner uv and two differences, one
    kind of footprint a quad: random gradients; isotropic (dx (a, 0), dy
    (0, a), a a power of two, so rx2 == ry2 on the square textures); ratio
    16 along x and along y (above the cap 4); zero gradients. The corner uv
    is a multiple of 1/64 in [-1.7, 2.3]."""
    rng = np.random.default_rng(seed)
    atlas = stub_atlas(rng, device, SPECS)
    hq, wq = H // 2, W // 2
    kind = rng.integers(0, 5, (hq, wq))
    a = 2.0 ** rng.integers(-9, -1, (hq, wq))
    dx = np.zeros((hq, wq, 2))
    dy = np.zeros((hq, wq, 2))
    rand = kind == 0
    dx[rand] = rng.normal(0, 0.03, (int(rand.sum()), 2))
    dy[rand] = rng.normal(0, 0.03, (int(rand.sum()), 2))
    for k, (sx, sy) in {1: (1.0, 1.0), 2: (1.0, 1 / 16), 3: (1 / 16, 1.0)}.items():
        dx[kind == k, 0] = a[kind == k] * sx
        dy[kind == k, 1] = a[kind == k] * sy
    base = np.round(rng.uniform(-1.7, 2.3, (hq, wq, 2)) * 64) / 64
    uv = np.zeros((H, W, 2))
    uv[0::2, 0::2] = base
    uv[0::2, 1::2] = base + dx
    uv[1::2, 0::2] = base + dy
    uv[1::2, 1::2] = base + dx + dy
    covered = rng.random((H, W)) > 0.15
    use = rng.random((H, W, 5)) > 0.4
    use[: H // 2] = True                     # every slot used in the top half
    tex = rng.integers(0, len(SPECS), (H, W, 5))
    mat = np.concatenate([rng.uniform(0, 1, (H, W, 3)), rng.uniform(0, 2, (H, W, 1)),
                          rng.uniform(0, 1, (H, W, 2)), use, tex], -1)
    nrm, tan = rng.normal(size=(H, W, 3)), rng.normal(size=(H, W, 3))
    planes = np.concatenate([uv, nrm, tan, mat], -1).transpose(2, 0, 1).astype(np.float32)
    tri_id = np.where(covered, 7, -1).astype(np.int32)
    depth = rng.uniform(0.5, 1.0, (H, W)).astype(np.float32)
    return atlas, *(torch.as_tensor(np.ascontiguousarray(x), device=device)
                    for x in (tri_id, depth, planes))


def sampler_inputs(tri_id, planes):
    """(uv, mask, use, tex) as `gbuffer._shade_from_interp` hands them to the
    sampler from the planes (uv from the masked interpolants)."""
    mask = tri_id >= 0
    interp = torch.where(mask[..., None], planes[0:8].permute(1, 2, 0), 0.0)
    matrow = planes[8:24].permute(1, 2, 0)
    use = matrow[..., 6:11] > 0.5
    tex = torch.clamp(matrow[..., 11:16].to(torch.int64), min=0)
    return interp[..., 0:2], mask, use, tex


def old_route(atlas, uv, mask, use, tex, use_tex_kernel=True):
    """The sampler as the G-buffer called it before the wrapper: `tap_lod`'s
    derivatives and sizes, then the filter at every pair."""
    ddx, ddy, size5, _ = gbuffer.tap_lod(uv, tex, mask, atlas, use_tex_kernel)
    return gbuffer.sample_atlas_anisotropic(atlas, tex, uv, ddx, ddy, size5, mask)


def census(atlas, uv, mask, use, tex) -> dict[str, int]:
    """Active pairs in each case the synthetic frame is built to reach."""
    ddx, ddy, size5, _ = gbuffer.tap_lod(uv, tex, mask, atlas, False)
    gx, gy = ddx[..., None, :] * size5, ddy[..., None, :] * size5
    rx2, ry2 = (gx * gx).sum(-1), (gy * gy).sum(-1)
    ratio2 = torch.maximum(rx2, ry2) / torch.clamp(torch.minimum(rx2, ry2), min=1e-12)
    act = use & mask[..., None]
    uv5 = uv[..., None, :].expand(*act.shape, 2)
    srgb = atlas.srgb[tex]
    return {"active": int(act.sum()), "all_five": int((act.sum(-1) == 5).sum()),
            "at_cap": int((act & (ratio2 > 16) & (rx2 > 0)).sum()),
            "major_y": int((act & (ry2 > rx2) & (ratio2 > 16)).sum()),
            "isotropic": int((act & (rx2 == ry2) & (rx2 > 0)).sum()),
            "zero_gradient": int((act & (rx2 == 0) & (ry2 == 0)).sum()),
            "uv_below_0": int((act & (uv5 < 0).any(-1)).sum()),
            "uv_above_1": int((act & (uv5 > 1).any(-1)).sum()),
            "srgb": int((act & srgb).sum()), "linear": int((act & ~srgb).sum()),
            "textures": len(torch.unique(tex[act])), "background": int((~mask).sum())}


def check_census(c: dict[str, int]) -> None:
    assert c["textures"] == len(SPECS), c
    assert all(n > 0 for n in c.values()), c


@pytest.mark.parametrize("seed", SEEDS)
def test_cpu_route_is_the_filter_at_active_pairs(seed):
    atlas, tri_id, _, planes = synthetic_frame(seed)
    uv, mask, use, tex = sampler_inputs(tri_id, planes)
    check_census(census(atlas, uv, mask, use, tex))
    launches = LAUNCHES["aniso_sample"]
    got = aniso_cuda.aniso_sample(atlas, uv, mask, use, tex)
    assert LAUNCHES["aniso_sample"] == launches
    assert got.shape == (H, W, 5, 4) and got.dtype == torch.float32
    act = use & mask[..., None]
    want = old_route(atlas, uv, mask, use, tex, use_tex_kernel=False)
    assert torch.equal(got[act], want[act])
    assert not got[~act].any()
    assert torch.equal(got, aniso_cuda.aniso_sample_reference(atlas, uv, mask, use, tex))


@pytest.mark.parametrize("use_tex_kernel", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_gbuffer_is_unchanged_by_the_route(seed, use_tex_kernel, monkeypatch):
    atlas, tri_id, depth, planes = synthetic_frame(seed)

    def shade():
        return gbuffer.gbuffer_shade_planar(tri_id, depth, planes, atlas, "anisotropic",
                                            use_tex_kernel=use_tex_kernel)

    got = shade()
    with monkeypatch.context() as m:
        m.setattr(aniso_cuda, "aniso_sample",
                  lambda *args: old_route(*args, use_tex_kernel=use_tex_kernel))
        want = shade()
    for name in gbuffer.GBuffer._fields[:5]:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.tex_approx is None and want.tex_approx is None
    assert got.mask.any() and (got.albedo_emission != 0).any()


def _bad(case):
    atlas, tri_id, _, planes = synthetic_frame(0)
    uv, mask, use, tex = sampler_inputs(tri_id, planes)
    if case == "odd_width":
        uv, mask, use, tex = uv[:, 1:], mask[:, 1:], use[:, 1:], tex[:, 1:]
    elif case == "int32_tex":
        tex = tex.to(torch.int32)
    elif case == "use_shape":
        use = use[..., :4]
    elif case == "float_mask":
        mask = mask.float()
    elif case == "atlas_dtype":
        atlas = atlas._replace(n_mips=atlas.n_mips.long())
    return atlas, uv, mask, use, tex


@pytest.mark.parametrize("case", ["odd_width", "int32_tex", "use_shape", "float_mask",
                                  "atlas_dtype"])
def test_card_call_checks_refuse_bad_inputs(case):
    atlas, uv, mask, use, tex = _bad(case)
    with pytest.raises(ValueError):
        aniso_cuda._check(atlas, uv, mask, use, tex)


def test_card_call_checks_accept_the_frame():
    atlas, tri_id, _, planes = synthetic_frame(0)
    assert aniso_cuda._check(atlas, *sampler_inputs(tri_id, planes)) == (H, W)


def test_other_devices_are_refused():
    atlas, tri_id, _, planes = synthetic_frame(0)
    uv, mask, use, tex = sampler_inputs(tri_id, planes)
    with pytest.raises(ValueError, match="unsupported device"):
        aniso_cuda.aniso_sample(atlas, uv.to("meta"), mask, use, tex)
