"""Kernel D (csrc/deferred_shade.cu) against its plain PyTorch version on a
CUDA device, on the inputs the fused deferred pass builds on the card; and
a 256x96 frame of the default path (kernels A, B, C, D) on the card against
the same pipeline on the CPU (every kernel's plain version).

Kernel D is held to the CPU tests' bar: the HDR target within rtol 1e-4 /
atol 1e-5 on all but 0.1% of the pixels (a one-ulp difference in log or pow
can move a pixel's cluster slice); the frame to the JAX package's fidelity
bar, rmse <= 1e-3 on uint8/255. The kernel reads its planes in place
(contiguous, group-innermost, gb as a channel slice: bit-equal outputs, no
copy in a wrapper call, a raise on a layout it does not take) and skips only
work whose result is not read: all-background warps, a light set that no
lane hits, 0 and 64 active lights stay within the bar. Every light-loop
instance (None, and the light_dtype ones "float32", "bfloat16",
"float16") is bit-equal to the plain version on the recorded inputs and at
64 lights, and an instance code the launch does not know is an error the
wrapper raises. Needs the card:
marked `cuda`, skipped elsewhere (`python -m pytest --noconftest
tests/test_torch_*_cuda.py` on a GPU machine without JAX).
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


def _group_innermost(x):
    """x with the same values, laid out (tiles, blocks, 128, G)."""
    return x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def frame_inputs():
    """Kernel D's (args, kwargs) on a 256x96 default-path frame on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    scene, cfg, cam = _scene(256, 96)
    card = DeferredRenderPipeline(scene, cfg, device=torch.device("cuda", 0), **KNOBS)
    with recording(shade_fused, "deferred_kernel") as calls:
        card.render(cam)
    torch.cuda.synchronize()
    (kargs, kw), = calls
    return list(kargs), kw


def _variant(kargs, case):
    """Kernel D's inputs changed for one case: (args, whether every warp's
    light bodies are skipped)."""
    const, lights, off, cnts, staged, rec, fx, fy, gb = (x.clone() for x in kargs)
    if case == "background_warps":          # the first half of every tile's rows
        gb[:, 10, : gb.shape[2] // 2] = 0.0
    elif case == "no_light_hits":
        lights[:, 13] = 0.0
    elif case == "no_active_lights":
        const[21] = 0.0
    elif case == "lights_64":
        rng = np.random.default_rng(4)
        lights = torch.zeros(64, 14, device=gb.device)
        pos = torch.as_tensor(rng.uniform([-8, 0, -8], [8, 6, 8], (64, 3)), dtype=torch.float32)
        lights[:, 0:3] = pos
        lights[:, 3:6] = torch.as_tensor(rng.uniform(0.2, 1.0, (64, 3)), dtype=torch.float32)
        lights[:, 6:10] = torch.tensor([4.0, 1.0, 0.1, 0.05])
        # the sphere test's centres, in view space in front of the camera
        lights[:, 10:13] = torch.as_tensor(rng.uniform([-5, -3, 1], [5, 3, 20], (64, 3)),
                                           dtype=torch.float32)
        lights[:, 13] = torch.as_tensor(rng.uniform(1.0, 6.0, 64), dtype=torch.float32)
        const[21] = 64.0
    return [const, lights, off, cnts, staged, rec, fx, fy, gb]


@pytest.mark.parametrize("case", ["recorded", "background_warps", "no_light_hits",
                                  "no_active_lights", "lights_64"])
def test_kernel_reads_every_layout_and_skips_only_unread_work(device, frame_inputs, case):
    """Contiguous and group-innermost rec/fx/fy and gb as a channel slice
    give bit-equal outputs; all within the bar of the plain version, with
    the same hit counters; one wrapper call dispatches no tensor op but its
    output's allocation, and a complete trace of ten calls holds only the
    kernel."""
    kargs, kw = frame_inputs
    args = _variant(kargs, case)
    want = shade_fused.deferred_kernel_reference(*args, **kw)
    gb_big = torch.cat([args[8], torch.full_like(args[8][:, :3], float("nan"))], 1)
    layouts = {
        "contiguous": args[:5] + [x.contiguous() for x in args[5:]],
        "group_innermost": args[:5] + [_group_innermost(x) for x in args[5:8]] + args[8:],
        "gb_slice": args[:8] + [gb_big[:, :14]],
    }
    outs = {}
    for name, a in layouts.items():
        outs[name] = shade_fused.deferred_kernel(*a, **kw)
        assert torch.equal(outs[name], outs["contiguous"]), name
    got = outs["contiguous"].cpu().numpy()
    ref = want.cpu().numpy()
    assert np.isfinite(got).all()
    bad = ~np.isclose(got[:, :3], ref[:, :3], rtol=1e-4, atol=1e-5).all(1)
    assert bad.mean() <= 1e-3, (bad.sum(), np.abs(got - ref).max())
    assert (got[:, 3] != ref[:, 3]).mean() <= 1e-3
    if case in ("no_light_hits", "no_active_lights"):
        assert (got[:, 3] == 0).all()
    if case == "lights_64":
        assert got[:, 3].max() > 1
    from chip_smoke import OUTPUT_OPS, device_spans, dispatched_ops

    def call():
        return shade_fused.deferred_kernel(*layouts["group_innermost"], **kw)

    ops = dispatched_ops(call)
    assert ops and all(op in OUTPUT_OPS for op in ops), ops
    names = {n for n, _ in device_spans(call, 10, "deferred_shade")}
    assert all("deferred_shade_kernel" in n for n in names), names


def test_wrapper_raises_on_a_layout_it_does_not_take(device, frame_inputs):
    kargs, kw = frame_inputs
    row_innermost = kargs[5].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="rec"):
        shade_fused.deferred_kernel(*kargs[:5], row_innermost, *kargs[6:], **kw)
    lanes_expanded = kargs[8][..., :1].expand(kargs[8].shape)
    with pytest.raises(ValueError, match="gb"):
        shade_fused.deferred_kernel(*kargs[:8], lanes_expanded, **kw)


@pytest.mark.parametrize("light_dtype", [None, "float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", ["recorded", "lights_64"])
def test_light_dtype_instances_bit_equal_to_plain(device, frame_inputs, light_dtype, case):
    """Kernel D's light loops (float32 with division, and the float32,
    bfloat16 and float16 instances) against the plain version's on the same
    inputs: every output bit equal (each op of the body rounded once to its
    type in both, sqrt and the reciprocal correctly rounded in float32).
    Each launch of an instance counts on its own counter as well as on the
    kernel's."""
    kargs, kw = frame_inputs
    args = _variant(kargs, case)
    kw = dict(kw, light_dtype=light_dtype)
    counter = f"{light_dtype}_launches" if light_dtype else "launches"
    n0, k0 = shade_fused.deferred_kernel.launches, getattr(shade_fused.deferred_kernel, counter)
    got = shade_fused.deferred_kernel(*args, **kw)
    assert (shade_fused.deferred_kernel.launches - n0,
            getattr(shade_fused.deferred_kernel, counter) - k0) == (1, 1)
    want = shade_fused.deferred_kernel_reference(*args, **kw)
    f32 = shade_fused.deferred_kernel_reference(*args, **dict(kw, light_dtype=None))
    differ = got.view(torch.int32) != want.view(torch.int32)
    assert not differ.any(), (int(differ.sum()), float((got - want).abs().max()))
    assert torch.equal(got[:, 3], f32[:, 3])           # the hit test stays float32
    if light_dtype not in (None, "float32"):
        assert not torch.equal(got[:, :3], f32[:, :3])


def test_unknown_light_dtype_code_is_an_error(device, frame_inputs, monkeypatch):
    """deferred_shade_launch refuses a light-loop code it has no instance
    for, and the wrapper raises its error."""
    kargs, kw = frame_inputs
    monkeypatch.setitem(shade_fused.LIGHT_DTYPES, "bogus", (torch.float32, 7))
    with pytest.raises(RuntimeError, match="launch failed"):
        shade_fused.deferred_kernel(*kargs, **dict(kw, light_dtype="bogus"))
