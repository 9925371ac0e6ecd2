"""Kernel F (csrc/env_resolve.cu) against its plain PyTorch version on a CUDA
device: on random staged pages with records that point past a group's
ceil8(cnt) pages and past the staged budget (both resolve to 0), and on the
inputs `envcache.sample_env_tiled` builds on the card for the deferred
pass's tap groups, whose outputs must equal the same call on the CPU.
Needs the card: marked `cuda`, skipped elsewhere (`python -m pytest
--noconftest tests/test_torch_*_cuda.py` on a GPU machine without JAX).

Both sides read the same bf16 words and blend them with the same weights
in the same order, so the bar is tight: rtol 1e-6 / atol 1e-7.
"""

import numpy as np
import pytest
import torch

from chip_smoke import recording
from direct12pbrrenderer_tpu_torch.ops import common, env_resolve_cuda, envcache

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_kernel_matches_plain_version_on_random_pages(device):
    rng = np.random.default_rng(0)
    tiles, g, blocks, budget = 6, 5, 24, 96
    words = envcache.pack_bf16(rng.random((tiles * budget * 128, 16)).astype(np.float32))
    staged = torch.as_tensor(words.reshape(tiles, budget, 128, 8).transpose(0, 1, 3, 2)
                             .reshape(tiles, budget * 8, 128).copy())
    off = torch.as_tensor(np.sort(rng.integers(0, budget, (tiles, g)), 1).astype(np.int32))
    cnts = torch.as_tensor(rng.integers(1, 30, (tiles, g)).astype(np.int32))
    seg = rng.integers(0, 40, (tiles, g, blocks, 128))        # some beyond ceil8(cnt)
    rec = torch.as_tensor((seg * 128 + rng.integers(0, 128, seg.shape)).astype(np.int32))
    fx, fy = (torch.as_tensor(rng.random(seg.shape).astype(np.float32)) for _ in range(2))
    args = (off, cnts, staged, rec, fx, fy)
    want = env_resolve_cuda.env_resolve_reference(*args)
    before = env_resolve_cuda.env_resolve.launches
    got = env_resolve_cuda.env_resolve(*(x.to(device) for x in args))
    torch.cuda.synchronize()
    assert env_resolve_cuda.env_resolve.launches == before + 1
    got = got.cpu()
    assert (want == 0).any() and (want != 0).any()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_sample_env_tiled_on_the_card_matches_the_cpu(device):
    rng = np.random.default_rng(5)
    b = envcache.FloatAtlasBuilder()
    env_base = b.add_cube([[rng.random((16 >> m, 16 >> m, 3)).astype(np.float32)
                            for m in range(4)] for _ in range(6)])
    sky_base = b.add_cube([[rng.random((8, 8, 3)).astype(np.float32)] for _ in range(6)])
    lut_tid = b.add([rng.random((8, 8, 2)).astype(np.float32)])
    h, w = 48, 256

    def dirs():
        d = torch.as_tensor(rng.normal(size=(h, w, 3)).astype(np.float32))
        return common.cubemap_coords(d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))

    (fe, ue, ve), (fs, us, vs) = dirs(), dirs()
    rough = torch.as_tensor(rng.random((h, w), dtype=np.float32))
    ndv = torch.as_tensor(rng.random((h, w), dtype=np.float32))
    mask = torch.as_tensor(rng.random((h, w)) > 0.4)
    lo = torch.floor(torch.clamp(rough * 5.0, 0.0, 3.0)).to(torch.int32)
    zero = torch.zeros_like(lo)
    stacks = (torch.stack([env_base + fe, env_base + fe, torch.full_like(lo, lut_tid),
                           sky_base + fs], -1).to(torch.int32),
              torch.stack([lo, torch.clamp(lo + 1, max=3), zero, zero], -1),
              torch.stack([ue, ue, rough, us], -1), torch.stack([ve, ve, ndv, vs], -1),
              torch.stack([mask, mask, mask, ~mask], -1))
    env_t, sky_t = tuple(range(env_base, env_base + 6)), tuple(range(sky_base, sky_base + 6))
    kw = dict(fb_tids=(env_t, env_t, (lut_tid,), sky_t), share=((0, 1),), cap=40)
    want = envcache.sample_env_tiled(b.build("cpu"), *stacks, **kw)
    with recording(env_resolve_cuda, "env_resolve") as calls:
        got = envcache.sample_env_tiled(b.build(device), *(x.to(device) for x in stacks), **kw)
    (kargs, _), = calls
    torch.testing.assert_close(env_resolve_cuda.env_resolve(*kargs).cpu(),
                               env_resolve_cuda.env_resolve_reference(*kargs).cpu(),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=1e-7)
