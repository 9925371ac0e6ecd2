"""Kernel E (csrc/atlas_resolve.cu) against its plain PyTorch version on a
CUDA device, on planned inputs (trilinear, bilinear, the LOD cascade, an
18-row tile); and a 256x96 frame of the planar texture-cache path on the
card (kernels A, B, E, F) against the same pipeline on the CPU (every
kernel's plain version).

E and its plain version read the same staged words and blend with every
product and sum rounded separately: the rgba is expected bit-equal. The
frame is held to the JAX package's fidelity bar, rmse <= 1e-3 on uint8/255,
with equal FrameStats. Needs the card: marked `cuda`, skipped elsewhere
(`python -m pytest --noconftest tests/test_torch_*_cuda.py` on a GPU machine
without JAX).
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import recording, stub_atlas
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import atlas_resolve_cuda, texcache

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


PLANS = {
    "trilinear": (48, 256, dict(trilinear=True, cap_lo=92, cap_hi=44, block_cap=16,
                                stage_budget=None)),
    "bilinear": (48, 256, dict(trilinear=False, cap_lo=92, cap_hi=44, block_cap=16,
                               stage_budget=None)),
    "cascade": (48, 256, dict(trilinear=True, cap_lo=4, cap_hi=4, block_cap=(4, 4),
                              stage_budget=None, cascade=True, cap_casc=12,
                              block_cap_casc=8, casc_mip=1)),
    "rows_18": (36, 128, dict(trilinear=True, cap_lo=156, cap_hi=44, block_cap=(32, 16),
                              stage_budget=None)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_resolve_kernel_matches_plain_version(device, name):
    h, w, kw = PLANS[name]
    rng = np.random.default_rng(13)
    atlas = stub_atlas(rng, device)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = torch.as_tensor((xx / w * 1.4 + rng.random((h, w)) * 0.01).astype(np.float32))
    v = torch.as_tensor((yy / h * 1.1 + rng.random((h, w)) * 0.01).astype(np.float32))
    tex = torch.as_tensor(rng.integers(0, 3, (h, w, 5)).astype(np.int32))
    lod = torch.as_tensor((0.5 + rng.random((h, w, 5)) * 2.0).astype(np.float32))
    act = torch.as_tensor(rng.random((h, w, 5)) > 0.2)
    th, tw = texcache.pick_tile(h, w)
    tiled = [texcache._tile(x.permute(2, 0, 1), th, tw).to(device)
             for x in (tex, u[..., None].expand(tex.shape), v[..., None].expand(tex.shape),
                       lod, act)]
    plan = texcache._plan_and_stage(atlas, *tiled, **kw)
    args = (*plan[:7], plan[8])
    before = LAUNCHES["atlas_resolve"]
    got = atlas_resolve_cuda.atlas_resolve(*args, trilinear=kw["trilinear"])
    torch.cuda.synchronize()
    assert LAUNCHES["atlas_resolve"] == before + 1
    want = atlas_resolve_cuda.atlas_resolve_reference(*args, trilinear=kw["trilinear"])
    assert got.shape == want.shape == (plan[3].shape[0], 5, 4, th * tw // 128, 128)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    if name == "cascade":
        assert plan[8].any()


def test_planar_tex_frame_on_the_card_matches_the_cpu_frame(device):
    from chip_smoke import stress_scene
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera

    scene = stress_scene(64, 32, 32, 20.0)
    cfg = RenderConfig(256, 96, max_instances=2)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    knobs = dict(tile_h=24, tile_w=64, bin_cap=4096, atlas_max_dim=256, prefilter_size=16,
                 brdf_lut_size=32, use_pallas=True, use_tex_kernel=True)
    card = DeferredRenderPipeline(scene, cfg, device=device, **knobs)
    assert card.use_tex_kernel and not card.use_fused_gbuffer
    cpu = DeferredRenderPipeline(scene, cfg, device="cpu", **knobs)
    before = (LAUNCHES["raster_interp"], LAUNCHES["fused_cover"],
              LAUNCHES["env_resolve"])
    with recording(atlas_resolve_cuda, "atlas_resolve") as calls:
        a = card.render(cam).cpu().numpy().astype(np.float64) / 255.0
    torch.cuda.synchronize()
    after = (LAUNCHES["raster_interp"], LAUNCHES["fused_cover"],
             LAUNCHES["env_resolve"])
    # kernel E's launch went through the recorder; A, B (3 texture + 1 env)
    # and F counted
    assert [y - x for x, y in zip(before, after)] == [1, 4, 1] and len(calls) == 1
    b = cpu.render(cam).numpy().astype(np.float64) / 255.0
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3
    assert card.last_stats == cpu.last_stats
    (kargs, kw), = calls
    got = atlas_resolve_cuda.atlas_resolve(*kargs, **kw)
    want = atlas_resolve_cuda.atlas_resolve_reference(*kargs, **kw)
    assert torch.equal(got, want)
