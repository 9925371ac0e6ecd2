"""Kernel C (csrc/resolve_shade.cu) against its plain PyTorch version on a
CUDA device, on the plan the fused G-buffer builds on the card; and the
whole fused G-buffer (kernels B and C) against the same function on the
CPU (every kernel's plain version). The bar is the JAX package's for this
shade (test_texcache.py): every channel within 1.01/255 and at most 2e-3 of
values differing; the fallback-tap counts are equal. Needs the card: marked
`cuda`, skipped elsewhere (`python -m pytest --noconftest
tests/test_torch_*_cuda.py` on a GPU machine without JAX).
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_raster_planes, recording, stub_atlas
from direct12pbrrenderer_tpu_torch.ops import resolve_shade_cuda, texcache

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _check(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= 1.01 / 255.0
    assert (np.abs(a - b) > 1e-6).mean() < 2e-3


@pytest.mark.parametrize("case", [
    dict(filter="trilinear"),
    dict(filter="bilinear"),
    dict(filter="trilinear", cascade=True, cap_lo=4, cap_hi=4, block_cap=(4, 4)),
    dict(filter="trilinear", stage_budget=160, block_cap=(24, 12)),
])
def test_fused_gbuffer_kernels_match_plain_versions(device, case):
    h, w, th, tw = 96, 256, 24, 128
    pl_tiles, id_tiles = random_raster_planes(np.random.default_rng(3), h, w, th, tw)
    args = (pl_tiles, id_tiles, h, w, th, tw)
    with recording(resolve_shade_cuda, "resolve_shade") as calls:
        got, got_approx = texcache.shade_planes_fused(
            stub_atlas(np.random.default_rng(1), device),
            *(torch.as_tensor(x, device=device) for x in args[:2]), *args[2:], **case)
    torch.cuda.synchronize()
    (kargs, kw), = calls
    _check(resolve_shade_cuda.resolve_shade(*kargs, **kw),
           resolve_shade_cuda.resolve_shade_reference(*kargs, **kw))
    want, want_approx = texcache.shade_planes_fused(
        stub_atlas(np.random.default_rng(1), "cpu"),
        *(torch.as_tensor(x) for x in args[:2]), *args[2:], **case)
    _check(got, want)
    assert int(got_approx) == int(want_approx)
    if "cascade" in case:
        assert kargs[-1] is not None and kargs[-1].any()
