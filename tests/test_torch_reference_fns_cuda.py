"""The JAX package's reference-only functions, ported as plain PyTorch, on a
CUDA device against the same calls on the CPU: chip_smoke.py's
[reference-fns] comparisons at test size, at its bars (chip_smoke.REF_*).
Needs the card: marked `cuda`, skipped elsewhere (`python -m pytest
--noconftest tests/test_torch_*_cuda.py` on a GPU machine without JAX).
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import (REF_BARY_ATOL, REF_BARY_RTOL, REF_BLOOM_BAR, REF_DECISION_FRAC,
                        REF_PF_ATOL, REF_PF_RTOL, REF_SAMPLER_RTOL, cluster_members,
                        procedural_sky, random_triangles, within)
from direct12pbrrenderer_tpu_torch.ops import bloom, clustered, common, ibl, raster

pytestmark = pytest.mark.cuda
CPU = torch.device("cpu")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _on(d, *xs):
    return [torch.as_tensor(np.ascontiguousarray(x), device=d) for x in xs]


def test_bloom_reference_on_the_card(device):
    img = (np.random.default_rng(11).random((96, 128, 3)) * 12.0).astype(np.float32)
    hdr, = _on(device, img)
    literal = bloom.bloom_reference(hdr)
    assert within(bloom.bloom(hdr), literal, REF_BLOOM_BAR, REF_BLOOM_BAR)
    assert within(literal, bloom.bloom_reference(hdr.cpu()), REF_BLOOM_BAR, REF_BLOOM_BAR)
    for name in ("blur_h", "blur_v"):
        assert within(getattr(bloom, name)(hdr), getattr(bloom, name)(hdr.cpu()),
                      REF_BLOOM_BAR, REF_BLOOM_BAR)


def test_cluster_lists_on_the_card(device):
    rng = np.random.default_rng(1)
    n = 300
    bounds = clustered.cluster_bounds(math.pi / 3.0, 16 / 9, 0.1, 100.0)
    pos = np.stack([rng.uniform(-40, 40, n), rng.uniform(-5, 20, n),
                    rng.uniform(-60, 40, n)], -1).astype(np.float32)
    att = np.stack([rng.uniform(1, 12, n), np.ones(n), rng.uniform(0, 0.2, n),
                    rng.uniform(0, 0.05, n)], -1).astype(np.float32)
    intensity = rng.uniform(0.1, 4.0, n).astype(np.float32)
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.9
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [-3.0, -6.0, 20.0]
    out = {}
    for d in (device, CPU):
        b, v, p, r, i, ok = _on(d, bounds, view, pos, att[:, 0], intensity, valid)
        out[d.type] = clustered.cull_lights_to_clusters(b, v, p, r, i, ok)
    (lists, counts), (lists_c, counts_c) = out["cuda"], out["cpu"]
    differ = int((cluster_members(lists, n) != cluster_members(lists_c, n)).sum())
    assert differ <= max(1, int(REF_DECISION_FRAC * bounds.shape[0] * n)), differ
    assert int((counts.cpu() - counts_c).abs().sum()) <= differ
    assert int(counts.sum()) > 0 and lists.device.type == "cuda"
    rows = clustered.build_cluster_light_params(lists, *_on(device, pos, color, intensity, att))
    rows_c = clustered.build_cluster_light_params(lists.cpu(), *_on(CPU, pos, color, intensity,
                                                                    att))
    assert torch.equal(rows.cpu(), rows_c)


def test_cluster_index_image_on_the_card(device):
    rng = np.random.default_rng(4)
    planes = [rng.uniform(-0.05, 1.05, (96, 256)).astype(np.float32),
              rng.uniform(-0.05, 1.05, (96, 256)).astype(np.float32),
              np.exp(rng.uniform(np.log(0.05), np.log(150.0), (96, 256))).astype(np.float32)]
    got = clustered.cluster_index_image(*_on(device, *planes), 0.1, 100.0)
    want = clustered.cluster_index_image(*_on(CPU, *planes), 0.1, 100.0)
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert int((got.cpu() != want).sum()) <= max(1, int(REF_DECISION_FRAC * want.numel()))


def test_barycentrics_on_the_card(device):
    clip, tris, _ = random_triangles(300, 0, device)
    setup = raster.setup_triangles(clip, tris, torch.ones(tris.shape[0], dtype=torch.bool,
                                                          device=device), 256, 192)
    rng = np.random.default_rng(3)
    ids, = _on(device, rng.integers(0, tris.shape[0], 4096))
    px, py = _on(device, (rng.integers(0, 256, 4096) + 0.5).astype(np.float32),
                 (rng.integers(0, 192, 4096) + 0.5).astype(np.float32))
    at = raster.barycentrics_at(setup, ids, px, py)
    from_packed = raster.barycentrics_from_packed(raster.pack_pixel_data(setup), ids, px, py)
    at_c = raster.barycentrics_at(raster.TriangleSetup(*(t.cpu() for t in setup)), ids.cpu(),
                                  px.cpu(), py.cpu())
    for a, b, c in zip(at, from_packed, at_c):
        assert torch.equal(a, b)
        assert within(a, c, REF_BARY_RTOL, REF_BARY_ATOL)


@pytest.mark.parametrize("wrap", [True, False])
def test_sample_texture2d_bilinear_on_the_card(device, wrap):
    rng = np.random.default_rng(7)
    tex = rng.uniform(0.2, 1, (64, 48, 4)).astype(np.float32)
    u = rng.uniform(-1.7, 2.6, (96, 128)).astype(np.float32)
    v = rng.uniform(-2.3, 1.9, (96, 128)).astype(np.float32)
    got = common.sample_texture2d_bilinear(*_on(device, tex, u, v), wrap=wrap)
    want = common.sample_texture2d_bilinear(*_on(CPU, tex, u, v), wrap=wrap)
    assert got.device.type == "cuda" and within(got, want, REF_SAMPLER_RTOL, 0.0)


def test_prefilter_env_map_from_texture_on_the_card(device):
    sky = procedural_sky(32, (0.4, 0.6, 0.3), 80.0).cubemap
    got = ibl.prefilter_env_map_from_texture(sky, out_size=16, device=device)
    want = ibl.prefilter_env_map_from_texture(sky, out_size=16, device=CPU)
    assert [m.shape for m in got] == [m.shape for m in want]
    for a, b in zip(got, want):
        assert within(torch.as_tensor(a), torch.as_tensor(b), REF_PF_RTOL, REF_PF_ATOL)
