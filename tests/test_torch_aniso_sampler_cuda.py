"""The anisotropic sampler's kernel (`csrc/aniso_sample.cu`) on the card,
held bit for bit to its plain version `aniso_cuda.aniso_sample_reference`
run on the card:

* on the synthetic frame of `tests/test_torch_aniso_sampler.py` (five
  textures of different sizes and mip counts, sRGB and linear, all five
  slots used, uv outside [0, 1], footprints at the ratio cap and with
  rx2 == ry2, background pixels): the samples at every pair, and the whole
  G-buffer of `gbuffer_shade_planar` with the kernel against the one with
  the plain version;
* at 1920x1080 on a pose of the benchmark's `terrain_aniso` configuration:
  the frame's recorded sampler call, and the G-buffer of the frame's
  recorded planes, both routes;
* the captured frame of that configuration: a replay launches the kernel
  once, and its images, FrameStats and exposure carry equal those of a
  pipeline whose sampler is the plain version.

Needs the card: marked `cuda`, skipped elsewhere (`python -m pytest
--noconftest tests/test_torch_aniso_sampler_cuda.py` on a GPU machine).
"""

import gc
import json

import pytest
import torch

from chip_smoke import recording
from direct12pbrrenderer_tpu_torch.kernels.launch import LAUNCHES
from direct12pbrrenderer_tpu_torch.ops import aniso_cuda, gbuffer
from test_torch_aniso_sampler import SEEDS, census, check_census, sampler_inputs, \
    synthetic_frame

pytestmark = pytest.mark.cuda
SEED = 2**31 + 4093      # the scene's and the poses' seed
POSES = 3


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _gbuffers(monkeypatch, args, kw):
    """The planar G-buffer of `gbuffer_shade_planar(*args, **kw)` with the
    kernel, then with the plain version."""
    def shade():
        return gbuffer.gbuffer_shade_planar(*args, **kw)

    launches = LAUNCHES["aniso_sample"]
    got = shade()
    assert LAUNCHES["aniso_sample"] == launches + 1
    with monkeypatch.context() as m:
        m.setattr(aniso_cuda, "aniso_sample", aniso_cuda.aniso_sample_reference)
        want = shade()
    return got, want


def _equal_gbuffers(got, want):
    for name in gbuffer.GBuffer._fields[:5]:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.mask.any()


@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_equals_the_plain_version_on_the_synthetic_frame(device, seed, monkeypatch):
    atlas, tri_id, depth, planes = synthetic_frame(seed, device)
    args = (atlas, *sampler_inputs(tri_id, planes))
    check_census(census(*args))
    got = aniso_cuda.aniso_sample(*args)
    want = aniso_cuda.aniso_sample_reference(*args)
    assert torch.equal(got, want)
    _equal_gbuffers(*_gbuffers(monkeypatch, (tri_id, depth, planes, atlas, "anisotropic"),
                               dict(use_tex_kernel=True)))


def _terrain_aniso(device):
    """(configuration, pipeline, poses) of the benchmark's terrain_aniso at
    full size on the card, as the benchmark builds them."""
    from benchmark import cells, program
    from benchmark.scenes import stress

    cfg = json.loads((cells.HERE / "configs" / "terrain_aniso.json").read_text())
    traffic = json.loads((cells.HERE / "traffic" / "stream.json").read_text())
    pipe = program.pipeline(cfg, program.port_scene(stress.build(cfg["scene"], SEED)), device)
    assert pipe.texture_filter == "anisotropic" and not pipe.use_fused_gbuffer
    cams = [program.camera(cfg, cells.pose(traffic, SEED, 17 * k)) for k in range(POSES)]
    return cfg, pipe, cams, traffic["delta_time"]


def test_kernel_equals_the_plain_version_at_1080p(device, monkeypatch):
    _, pipe, cams, dt = _terrain_aniso(device)
    with recording(aniso_cuda, "aniso_sample") as calls, \
            recording(gbuffer, "gbuffer_shade_planar") as shades:
        pipe.render(cams[0], dt, collect_stats=False)
        torch.cuda.synchronize()
    (args, kw), = calls
    (sargs, skw), = shades
    assert args[1].shape == (1080, 1920, 2)
    got = aniso_cuda.aniso_sample(*args, **kw)
    want = aniso_cuda.aniso_sample_reference(*args, **kw)
    assert torch.equal(got, want)
    act = args[3] & args[2][..., None]
    assert int(act.sum()) * 4 > 5_000_000      # the frame's taps (about 5.28M)
    del got, want, act
    assert sargs[4] == "anisotropic"
    _equal_gbuffers(*_gbuffers(monkeypatch, sargs, skw))
    del pipe, calls, shades, args, sargs
    gc.collect()
    torch.cuda.empty_cache()


def test_captured_frames_launch_the_kernel_once_and_equal_the_plain_route(device, monkeypatch):
    def render_plain(c):              # its captures take the plain sampler
        with monkeypatch.context() as m:
            m.setattr(aniso_cuda, "aniso_sample", aniso_cuda.aniso_sample_reference)
            return plain.render(c, dt)

    _, kern, cams, dt = _terrain_aniso(device)
    kern.render(cams[0], dt)          # the capture, with the kernel
    _, plain, _, _ = _terrain_aniso(device)
    render_plain(cams[0])
    plain.avg_luminance = kern.avg_luminance.clone()
    for c in cams:
        before = LAUNCHES["aniso_sample"]
        got = kern.render(c, dt)
        torch.cuda.synchronize()
        assert LAUNCHES["aniso_sample"] - before == 1
        want = render_plain(c)
        assert torch.equal(got, want)
        assert kern.last_stats == plain.last_stats
        assert torch.equal(kern.avg_luminance, plain.avg_luminance)
    taps = []
    for pipe, render in ((kern, lambda c: kern.render(c, dt)), (plain, render_plain)):
        pipe.start_trace()            # a traced frame counts the sampler's taps
        render(cams[-1])
        pipe.stop_trace()
        taps.append(pipe.last_stats.tex_taps)
    assert taps[0] == taps[1] > 0
    del kern, plain
    gc.collect()
    torch.cuda.empty_cache()
