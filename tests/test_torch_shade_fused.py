"""The port's fused deferred pass (`ops/shade_fused.py`: tiled geometry, env
plan with kernel B's plain version, kernel D's plain version) against the
JAX package's `shade_pallas.deferred_shade_fused` in interpret mode, on the
same G-buffer tile blocks, env pages and active-light rows.

The HDR render target must agree within rtol 1e-4 / atol 1e-5 on all but
0.1% of the pixels (a one-ulp difference in a log or pow can move a pixel's
cluster slice, and the port's geometry sums in another order than XLA's
einsum), and the env fallback-tap count must be equal. 40 lights crowd one
region so the per-cluster cap of 32 binds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.config import RenderConfig
from direct12pbrrenderer_tpu.ops import clustered as jclustered
from direct12pbrrenderer_tpu.ops import envcache as jenv
from direct12pbrrenderer_tpu.ops import shade_pallas
from direct12pbrrenderer_tpu.scene.camera import Camera
from direct12pbrrenderer_tpu_torch.ops import envcache, shade_fused

torch.set_num_threads(2)
H, W, TH, TW = 48, 256, 24, 128


def _q8(x):
    return np.round(np.clip(x, 0.0, 1.0) * 255.0) / 255.0


def _inputs(seed, has_env):
    rng = np.random.default_rng(seed)
    cfg = RenderConfig(W, H)
    cam = Camera(cfg.fov, W, H, cfg.near, cfg.far)
    cam.move([0.5, 1.0, 3.0])
    cam.rotate(0.0, 0.3, 0.1)
    tiles, p = (H // TH) * (W // TW), TH * TW
    blocks = p // 128

    # G-buffer tile blocks: smooth normals and depth, random materials, a
    # background band (id -1, depth inf, zero channels as kernel C writes)
    yy, xx = np.meshgrid(np.arange(H) / H, np.arange(W) / W, indexing="ij")
    gb = np.zeros((9, H, W), np.float32)
    gb[0:4] = _q8(rng.random((4, H, W)))
    gb[4] = _q8(0.3 + 0.4 * xx)
    gb[5] = _q8(0.6 - 0.3 * yy)
    gb[6:9] = _q8(rng.random((3, H, W)))
    ndc = (0.96 + 0.035 * yy + 0.002 * rng.random((H, W))).astype(np.float32)
    bg = (yy < 0.15) | (rng.random((H, W)) < 0.02)
    gb[:, bg] = 0.0
    ids = np.where(bg, -1, 7).astype(np.int32)
    ndc = np.where(bg, np.inf, ndc).astype(np.float32)

    def to_tiles(x):   # (C, H, W) -> (tiles, C, blocks, 128) / (tiles, p, C)
        c = x.shape[0]
        t = x.reshape(c, H // TH, TH, W // TW, TW).transpose(1, 3, 0, 2, 4)
        return t.reshape(tiles, c, p)

    gb_tiles = np.ascontiguousarray(to_tiles(gb).reshape(tiles, 9, blocks, 128))
    z_tiles = np.ascontiguousarray(to_tiles(ndc[None]).transpose(0, 2, 1))
    id_tiles = np.ascontiguousarray(to_tiles(ids[None]).transpose(0, 2, 1))

    # 40 lights crowded in front of the camera (the cap-32 counter binds)
    n = 40
    view = cam.view_matrix().astype(np.float32)
    inv_view = cam.world_matrix().astype(np.float32)
    local = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(2.0, 6.0, n), np.ones(n)], -1).astype(np.float32)
    pos = (local @ inv_view.T)[:, :3].astype(np.float32)
    color = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    intensity = rng.uniform(20.0, 80.0, n).astype(np.float32)
    atten = np.tile(np.array([[4.0, 1.0, 0.09, 0.032]], np.float32), (n, 1))
    active = np.array(jclustered.build_active_lights(
        jnp.asarray(pos), jnp.asarray(color), jnp.asarray(intensity), jnp.asarray(atten),
        jnp.ones((n,), bool), jnp.asarray(view), 64))

    # env pages: prefiltered env chain, sky faces, BRDF LUT
    n_mips = 4
    env = [[rng.random((16 >> m, 16 >> m, 3)).astype(np.float32) for m in range(n_mips)]
           for _ in range(6)]
    sky = [[rng.random((8, 8, 3)).astype(np.float32)] for _ in range(6)]
    lut = rng.random((16, 16, 2)).astype(np.float32)
    atlases = []
    for builder in (jenv.FloatAtlasBuilder(), envcache.FloatAtlasBuilder()):
        ids_ = (builder.add_cube(env), builder.add_cube(sky), builder.add([lut]))
        atlases.append(builder)
    env_ids = (*ids_, n_mips, has_env)
    sh_pack = (rng.normal(size=(7, 4)) * 0.2).astype(np.float32)
    cam_pos = np.asarray(cam.position, np.float32)
    return dict(gb_tiles=gb_tiles, z_tiles=z_tiles, id_tiles=id_tiles, sh_pack=sh_pack,
                active=active, inv_view=inv_view, cam_pos=cam_pos, env_ids=env_ids,
                atlases=atlases, cfg=cfg, bg=bg)


@pytest.mark.parametrize("has_env", [True, False])
def test_deferred_shade_fused_matches_jax(has_env):
    d = _inputs(5, has_env)
    cfg = d["cfg"]
    common = (d["env_ids"], cfg.fov, cfg.ratio, cfg.near, cfg.far, W, H, TH, TW)
    want_rt, want_approx = shade_pallas.deferred_shade_fused(
        *(jnp.asarray(d[k]) for k in ("gb_tiles", "z_tiles", "id_tiles", "sh_pack")),
        d["atlases"][0].build(), jnp.asarray(d["active"]), jnp.asarray(d["inv_view"]),
        jnp.asarray(d["cam_pos"]), *common, interpret=True)
    got_rt, got_approx = shade_fused.deferred_shade_fused(
        *(torch.as_tensor(d[k]) for k in ("gb_tiles", "z_tiles", "id_tiles", "sh_pack")),
        d["atlases"][1].build("cpu"), torch.as_tensor(d["active"]),
        torch.as_tensor(d["inv_view"]), torch.as_tensor(d["cam_pos"]), *common)
    a, b = np.asarray(want_rt), got_rt.numpy()
    assert a.shape == b.shape == (H, W, 3)
    assert np.isfinite(b).all() and b[~d["bg"]].max() > 0.05
    bad = ~np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 1e-3, (bad.sum(), np.abs(a - b).max())
    assert int(got_approx) == int(want_approx)


def test_light_cap_binds_and_kernel_reference_counts_hits():
    """The plain kernel's 4th channel is the per-pixel cluster-hit counter:
    40 crowded lights overlap every cluster of the slab, and the counter
    stops at 32."""
    d = _inputs(6, True)
    cfg = d["cfg"]
    tiles, blocks = d["gb_tiles"].shape[0], d["gb_tiles"].shape[2]
    cst = torch.zeros(64)
    cst[:4] = torch.tensor([math.tan(cfg.fov / 2), cfg.ratio, cfg.near, cfg.far])
    cst[4:7] = torch.as_tensor(d["cam_pos"])
    cst[8:17] = torch.as_tensor(d["inv_view"][:3, :3].reshape(9))
    cst[17:21] = torch.tensor([W, H, math.log(cfg.far / cfg.near), cfg.far / cfg.near])
    active = torch.as_tensor(d["active"])
    cst[21] = float((active[:, 13] > 0).sum())
    gbk = torch.zeros(tiles, 14, blocks, 128)
    gbk[:, 6] = 1.0                                   # normals toward +z
    gbk[:, 9] = 4.0                                   # z_view inside the lights' slab
    gbk[:, 10] = 1.0                                  # covered
    g = 5
    off = torch.zeros(tiles, g, dtype=torch.int32)
    cnts = torch.zeros(tiles, g, dtype=torch.int32)
    staged = torch.zeros(tiles, 8 * 8, 128, dtype=torch.int32)
    rec = torch.zeros(tiles, g, blocks, 128, dtype=torch.int32)
    fx = torch.zeros(tiles, g, blocks, 128)
    out = shade_fused.deferred_kernel(cst, active, off, cnts, staged, rec, fx, fx, gbk,
                                      has_env=True, tile_h=TH, tile_w=TW, tiles_x=W // TW)
    counter = out[:, 3]
    assert int(cst[21]) == 40
    assert (counter == 32).all()
