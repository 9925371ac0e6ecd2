"""Kernel D (csrc/deferred_shade.cu) against its plain PyTorch version on a
CUDA device, on the inputs the fused deferred pass builds on the card; and
a 256x96 frame of the default path (kernels A, B, C, D) on the card against
the same pipeline on the CPU (every kernel's plain version).

Kernel D is held to the CPU tests' bar: the HDR target within rtol 1e-4 /
atol 1e-5 on all but 0.1% of the pixels (a one-ulp difference in log or pow
can move a pixel's cluster slice); the frame to the JAX package's fidelity
bar, rmse <= 1e-3 on uint8/255. Needs the card: marked `cuda`, skipped
elsewhere (`python -m pytest --noconftest tests/test_torch_*_cuda.py` on a
GPU machine without JAX).
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import recording
from direct12pbrrenderer_tpu_torch.ops import (
    cover_cuda,
    raster_cuda,
    resolve_shade_cuda,
    shade_fused,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(w, h):
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera

    from chip_smoke import stress_scene

    scene = stress_scene(64, 32, 32, 20.0)
    cfg = RenderConfig(w, h, max_instances=2)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    return scene, cfg, cam


KNOBS = dict(tile_h=24, tile_w=128, bin_cap=4096, atlas_max_dim=256, prefilter_size=16,
             brdf_lut_size=32)


def _launches():
    return (raster_cuda.rasterize_interp.launches, cover_cuda.fused_cover.launches,
            resolve_shade_cuda.resolve_shade.launches, shade_fused.deferred_kernel.launches)


def test_default_frame_on_the_card_matches_the_cpu_frame(device):
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    scene, cfg, cam = _scene(256, 96)
    card = DeferredRenderPipeline(scene, cfg, device=device, **KNOBS)
    assert card.use_pallas and card.use_tex_kernel and card.use_fused_deferred
    cpu = DeferredRenderPipeline(scene, cfg, use_pallas=True, use_tex_kernel=True,
                                 device="cpu", **KNOBS)
    before = _launches()
    with recording(shade_fused, "deferred_kernel") as calls:
        a = card.render(cam).cpu().numpy().astype(np.float64) / 255.0
    torch.cuda.synchronize()
    after = _launches()
    # kernel D's launch went through the recorder; A, B (3 texture + 1 env)
    # and C counted on their wrappers
    assert [y - x for x, y in zip(before, after)][:3] == [1, 4, 1] and len(calls) == 1
    b = cpu.render(cam).numpy().astype(np.float64) / 255.0
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3
    assert card.last_stats == cpu.last_stats

    (kargs, kw), = calls
    got = shade_fused.deferred_kernel(*kargs, **kw)[:, :3].cpu().numpy()
    want = shade_fused.deferred_kernel_reference(*kargs, **kw)[:, :3].cpu().numpy()
    assert np.isfinite(got).all() and got.max() > 0.05
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(1)
    assert bad.mean() <= 1e-3, (bad.sum(), np.abs(got - want).max())


def test_deferred_kernel_light_cap(device):
    """40 lights over every cluster of the slab: the kernel's counter stops
    at 32, as the plain version's."""
    tiles, blocks, g = 2, 24, 5
    cst = torch.zeros(64)
    cst[:4] = torch.tensor([math.tan(0.5), 2.0, 0.1, 100.0])
    cst[17:21] = torch.tensor([256.0, 48.0, math.log(1000.0), 1000.0])
    cst[21] = 40.0
    rng = np.random.default_rng(2)
    lights = np.zeros((64, 14), np.float32)
    lights[:40, 0:3] = rng.uniform(-1, 1, (40, 3))
    lights[:40, 3:7] = 1.0
    lights[:40, 7] = 1.0
    lights[:40, 10:13] = rng.uniform(-1, 1, (40, 3)) + [0, 0, 4]
    lights[:40, 13] = 1000.0
    gbk = torch.zeros(tiles, 14, blocks, 128)
    gbk[:, 6] = 1.0
    gbk[:, 9] = 4.0
    gbk[:, 10] = 1.0
    kargs = [cst, torch.as_tensor(lights), torch.zeros(tiles, g, dtype=torch.int32),
             torch.zeros(tiles, g, dtype=torch.int32),
             torch.zeros(tiles, 64, 128, dtype=torch.int32),
             torch.zeros(tiles, g, blocks, 128, dtype=torch.int32),
             torch.zeros(tiles, g, blocks, 128), torch.zeros(tiles, g, blocks, 128), gbk]
    kw = dict(has_env=True, tile_h=24, tile_w=128, tiles_x=2)
    got = shade_fused.deferred_kernel(*(x.to(device) for x in kargs), **kw).cpu()
    want = shade_fused.deferred_kernel_reference(*kargs, **kw)
    assert (got[:, 3] == 32).all() and torch.equal(got[:, 3], want[:, 3])
    assert torch.isclose(got[:, :3], want[:, :3], rtol=1e-4, atol=1e-5).all()
