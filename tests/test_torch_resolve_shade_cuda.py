"""Kernel C (csrc/resolve_shade.cu) against its plain PyTorch version on a
CUDA device, on the plan the fused G-buffer builds on the card; and the
whole fused G-buffer (kernels B and C) against the same function on the
CPU (every kernel's plain version). The bar is the JAX package's for this
shade (test_texcache.py): every channel within 1.01/255 and at most 2e-3 of
values differing; the fallback-tap counts are equal. The kernel reads its
planes in place: contiguous, group-innermost and attrs as a channel slice of
the raster rows give bit-equal outputs, a wrapper call runs no copy, and the
wrapper raises on a layout the kernel does not take. Needs the card: marked
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


def _group_innermost(x):
    """x with the same values, laid out (tiles, blocks, 128, G)."""
    return x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def _raster_slice(attrs):
    """attrs (tiles, 17, blocks, 128) as channels 2..18 of (tiles, p, 24)
    raster rows, as the fused G-buffer hands them over."""
    tiles, _, blocks, _ = attrs.shape
    rows = torch.full((tiles, blocks * 128, 24), float("nan"), device=attrs.device)
    rows[..., 2:19] = attrs.permute(0, 2, 3, 1).reshape(tiles, blocks * 128, 17)
    return rows.reshape(tiles, blocks, 128, 24).permute(0, 3, 1, 2)[:, 2:19]


PLANES = (3, 4, 5, 6, 7, 8, 9)   # rec, fx, fy, tl, attrs, flags, sel


@pytest.mark.parametrize("case", [
    dict(filter="trilinear"),
    dict(filter="bilinear"),
    dict(filter="trilinear", cascade=True, cap_lo=4, cap_hi=4, block_cap=(4, 4)),
], ids=["trilinear", "bilinear", "cascade"])
def test_kernel_reads_every_layout_in_place(device, case):
    """Contiguous planes, group-innermost planes and attrs as a channel slice
    of the raster rows give bit-equal outputs, within the bar of the plain
    version; one wrapper call dispatches no tensor op but its output's
    allocation, and a complete trace of ten calls holds only the kernel."""
    h, w, th, tw = 96, 256, 24, 128
    pl_tiles, id_tiles = random_raster_planes(np.random.default_rng(3), h, w, th, tw)
    with recording(resolve_shade_cuda, "resolve_shade") as calls:
        texcache.shade_planes_fused(stub_atlas(np.random.default_rng(1), device),
                                    torch.as_tensor(pl_tiles, device=device),
                                    torch.as_tensor(id_tiles, device=device), h, w, th, tw,
                                    **case)
    (kargs, kw), = calls
    assert ("cascade" in case) == (kargs[9] is not None)
    if "cascade" in case:
        assert kargs[9].any() and not kargs[9].all()
    kargs = list(kargs)
    layouts = {
        "recorded": kargs,
        "contiguous": [x.contiguous() if i in PLANES and x is not None else x
                       for i, x in enumerate(kargs)],
        "group_innermost": [_group_innermost(x) if i in PLANES and x is not None else x
                            for i, x in enumerate(kargs)],
        "raster_slice": kargs[:7] + [_raster_slice(kargs[7])] + kargs[8:],
    }
    want = resolve_shade_cuda.resolve_shade_reference(*kargs, **kw)
    outs = {}
    for name, args in layouts.items():
        outs[name] = resolve_shade_cuda.resolve_shade(*args, **kw)
        _check(outs[name], want)
        assert torch.equal(outs[name], outs["recorded"]), name
    torch.cuda.synchronize()
    from chip_smoke import OUTPUT_OPS, device_spans, dispatched_ops

    def call():
        return resolve_shade_cuda.resolve_shade(*layouts["raster_slice"], **kw)

    ops = dispatched_ops(call)
    assert ops and all(op in OUTPUT_OPS for op in ops), ops
    names = {n for n, _ in device_spans(call, 10, "resolve_shade")}
    assert all("resolve_shade_kernel" in n for n in names), names


def test_wrapper_raises_on_a_layout_it_does_not_take(device):
    tiles, blocks = 2, 24
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    args = [torch.zeros(tiles, 10, **i32), torch.zeros(tiles, 10, **i32),
            torch.zeros(tiles, 64, 128, **i32), torch.zeros(tiles, 10, blocks, 128, **i32),
            torch.zeros(tiles, 10, blocks, 128, **f32), torch.zeros(tiles, 10, blocks, 128, **f32),
            torch.zeros(tiles, 5, blocks, 128, **f32), torch.zeros(tiles, 17, blocks, 128, **f32),
            torch.zeros(tiles, 6, blocks, 128, **i32)]
    resolve_shade_cuda.resolve_shade(*args)
    row_innermost = torch.zeros(tiles, 10, 128, blocks, **i32).transpose(2, 3)
    with pytest.raises(ValueError, match="rec"):
        resolve_shade_cuda.resolve_shade(*args[:3], row_innermost, *args[4:])
    with pytest.raises(ValueError, match="off"):
        resolve_shade_cuda.resolve_shade(args[0].t().contiguous().t(), *args[1:])
