"""The port's frame without host reads, on the CPU: the counterpart of the
JAX pipeline's `jax.jit(_frame)` and `render_sequence` (its `lax.scan`).

* `render_sequence` against the JAX package's over three poses of the
  default path (the fused G-buffer and deferred pass, 256x96, tile 24x128,
  the JAX pipeline's buffers loaded): every frame within the JAX package's
  fidelity bar, rmse <= 1e-3 on uint8/255, the exposure carry within rtol
  1e-5, and equal FrameStats on the frame that follows (the bars of
  tests/test_torch_pipeline.py's default-path frame).
* `raster.bin_triangles_hier`, whose fine pass no longer asks the host how
  wide to run, bit for bit against the JAX package's (its `lax.cond`) on a
  pool whose supertiles all hold at most cap1 // 4 candidates and on one
  whose supertiles hold more (some more than cap1).
* Bloom with its matrices cached on the device against the JAX package's
  `ops/bloom.bloom` (rtol 1e-5 / atol 1e-5, tests/test_torch_gbuffer_shading.py's
  bar), the second call making no host-to-device copy.
* A guard that fails the test on any host read of a tensor (`Tensor.item`,
  `tolist`, `__bool__`, `__int__`, `__float__`, `__index__`, `cpu`,
  `numpy`, and the aten ops they and boolean indexing dispatch) and on any
  tensor made from host data (`torch.tensor`) while `_frame` runs at the
  default path's knobs, or the hierarchical binning, outside the kernels'
  plain versions (which keep their host loop bounds: the card runs the
  kernels instead). On a card these are the syncs and pageable copies a
  CUDA graph capture refuses; `tests/test_torch_frame_graph_cuda.py` holds
  the captured frame there.
"""

import contextlib
import copy
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from direct12pbrrenderer_tpu.ops import bloom as jbloom
from direct12pbrrenderer_tpu.ops import raster as jraster
from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JaxPipeline
from direct12pbrrenderer_tpu_torch.ops import (bloom, cover_cuda, raster, raster_cuda,
                                              resolve_shade_cuda, shade_fused)
from direct12pbrrenderer_tpu_torch.pipeline import stages
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.state import state_from_jax
from direct12pbrrenderer_tpu_torch.tools.tiny_scene import tiny_pipeline
from test_torch_pipeline import FUSED_KNOBS, RMSE_BAR, _fused_scene, _poses, _rmse, jax_state

torch.set_num_threads(2)

# the kernels' plain versions: the CPU's stand-ins for kernels A-D, whose
# loop bounds (and kernel B's cap row) are host values
PLAIN_VERSIONS = {f.__code__ for f in (
    raster_cuda.rasterize_interp_reference, raster_cuda.rasterize_depth_reference,
    cover_cuda.fused_cover_reference, resolve_shade_cuda.resolve_shade_reference,
    shade_fused.deferred_kernel_reference)}
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "cpu",
              "numpy")
# aten ops that read a tensor on the host (a sync on a card: for bincount,
# histc and repeat_interleave the CUDA kernel reads its output size back) or
# make one from host data (a pageable upload on a card)
HOST_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.unique",
            "aten._unique2", "aten.unique_consecutive", "aten.unique_dim", "aten.bincount",
            "aten.histc", "aten.repeat_interleave", "aten.lift_fresh")


def _in_plain_version() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in PLAIN_VERSIONS:
            return True
        f = f.f_back
    return False


@contextlib.contextmanager
def no_host_reads():
    """Raise AssertionError on a host read of a tensor or a tensor made
    from host data while the block runs, outside the kernels' plain
    versions."""
    def guarded(name, orig):
        def fn(self, *args, **kwargs):
            if not _in_plain_version():
                raise AssertionError(f"Tensor.{name} in the frame")
            return orig(self, *args, **kwargs)
        return fn

    class Guard(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = f"aten.{func.overloadpacket.__name__}"
            bool_index = name == "aten.index" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1] or ())
            if (name in HOST_OPS or bool_index) and not _in_plain_version():
                raise AssertionError(f"{func} in the frame")
            return func(*args, **(kwargs or {}))

    originals = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    for name, orig in originals.items():
        setattr(torch.Tensor, name, guarded(name, orig))
    try:
        with Guard():
            yield
    finally:
        for name, orig in originals.items():
            setattr(torch.Tensor, name, orig)


@pytest.mark.parametrize("probe", [
    lambda: torch.ones(3).sum().item(), lambda: bool(torch.ones(1) > 0),
    lambda: torch.arange(4)[torch.arange(4) > 1], lambda: torch.tensor([1.0, 2.0]),
    lambda: int(torch.ones(())), lambda: torch.ones(2).tolist(),
    lambda: torch.bincount(torch.arange(3))])
def test_guard_catches_host_reads(probe):
    with pytest.raises(AssertionError), no_host_reads():
        probe()
    probe()   # and lets them through again


@pytest.mark.parametrize("light_dtype", [None, "bfloat16"])
def test_default_frame_makes_no_host_read(light_dtype):
    pipe, cam, _ = tiny_pipeline("cpu", width=256, height=96, tile_h=24, tile_w=128,
                                 use_pallas=True, use_tex_kernel=True,
                                 fused_light_dtype=light_dtype)
    assert pipe.use_fused_gbuffer and pipe.use_fused_deferred and not pipe.captured
    pipe.render(cam)   # fills the device constants' caches, as a capture's warm-up does
    pipe._upload(cam, 1.0 / 60.0)
    args = (pipe._scene_dev, pipe._cam_dev, pipe.avg_luminance)
    want = pipe._frame(*args)
    with no_host_reads():
        got = pipe._frame(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _pool(t: int, width: int, height: int, seed: int, size: float, valid_frac: float):
    """(port setup, JAX setup, aabb, valid) of `t` random screen AABBs up to
    `size` pixels wide, a `valid_frac` share of them valid."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(-20, width, t), rng.uniform(-20, height, t)
    x1, y1 = x0 + rng.uniform(1, size, t), y0 + rng.uniform(1, size, t)
    aabb = np.stack([np.clip(np.floor(x0), 0, width), np.clip(np.floor(y0), 0, height),
                     np.clip(np.ceil(x1), 0, width), np.clip(np.ceil(y1), 0, height)],
                    1).astype(np.float32)
    valid = ((rng.uniform(size=t) < valid_frac) & (aabb[:, 2] > aabb[:, 0])
             & (aabb[:, 3] > aabb[:, 1]))
    zeros = {"xy": (t, 3, 2), "z": (t, 3), "w_clip": (t, 3), "edges": (t, 3, 3)}
    ts = raster.TriangleSetup(**{k: torch.zeros(v) for k, v in zeros.items()},
                              aabb=torch.as_tensor(aabb), valid=torch.as_tensor(valid))
    js = jraster.TriangleSetup(**{k: jnp.zeros(v) for k, v in zeros.items()},
                               aabb=jnp.asarray(aabb), valid=jnp.asarray(valid))
    return ts, js, aabb, valid


def _supertile_counts(aabb, valid, tiles_y, tiles_x, tile_h, tile_w, y_offset):
    """Each (8 x 4)-tile supertile's overlap count, in numpy."""
    out = []
    for sy in range(-(-tiles_y // 8)):
        for sx in range(-(-tiles_x // 4)):
            x0, y0 = sx * 4 * tile_w, sy * 8 * tile_h + y_offset
            out.append(int((valid & (aabb[:, 0] < x0 + 4 * tile_w) & (aabb[:, 2] > x0)
                            & (aabb[:, 1] < y0 + 8 * tile_h) & (aabb[:, 3] > y0)).sum()))
    return np.array(out)


# (triangles, tiles_y, tiles_x, tile_h, tile_w, cap, cap1, size, valid share, y_offset)
HIER_POOLS = {
    # every supertile within cap1 // 4: JAX's narrow fine pass
    "sparse": (16384, 9, 8, 24, 128, 512, 4096, 60, 0.1, 0),
    # supertiles above cap1 // 4, some above cap1 (their tiles' counts read
    # cap + 1): JAX's full-width fine pass
    "dense": (20000, 10, 9, 12, 64, 256, 4096, 300, 1.0, 36),
}


@pytest.mark.parametrize("pool", sorted(HIER_POOLS))
def test_bin_triangles_hier_matches_jax(pool):
    t, ty, tx, th, tw, cap, cap1, size, frac, yoff = HIER_POOLS[pool]
    ts, js, aabb, valid = _pool(t, tx * tw, ty * th + yoff, 7 + t, size, frac)
    cnt1 = _supertile_counts(aabb, valid, ty, tx, th, tw, yoff)
    cap_small = max(cap, cap1 // 4)
    if pool == "sparse":
        assert 0 < cnt1.max() <= cap_small
    else:
        assert cnt1.max() > cap1 and cnt1.min() > cap_small
    want = jraster.bin_triangles_hier(js, ty, tx, th, tw, cap, y_offset=yoff, cap1=cap1)
    with no_host_reads():
        got = raster.bin_triangles_hier(ts, ty, tx, th, tw, cap, y_offset=yoff, cap1=cap1)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert (got.counts > cap).any() == (pool == "dense")


def test_binning_stage_takes_hier_without_host_reads():
    """The pipeline's binning stage at a pool of 16384 triangles and 64
    tiles (where it takes the hierarchical binning) reads nothing back."""
    ts, _, _, _ = _pool(16384, 8 * 128, 8 * 24, 3, 80, 1.0)
    want = raster.bin_triangles_hier(ts, 8, 8, 24, 128, 512, cap1=4096)
    with no_host_reads():
        got = stages.binning(ts, 8 * 128, 8 * 24, 24, 128, 512)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.counts, want.counts)


@pytest.mark.parametrize("hw", [(96, 256), (37, 53)])
def test_bloom_with_device_matrices_matches_jax(hw):
    rng = np.random.default_rng(11)
    hdr = (rng.uniform(0, 1, hw + (3,)) ** 4 * 6).astype(np.float32)
    x = torch.as_tensor(hdr)
    first = bloom.bloom(x)
    with no_host_reads():   # every matrix now comes from the cache
        got = bloom.bloom(x)
    assert torch.equal(got, first)
    np.testing.assert_allclose(got.numpy(), np.asarray(jbloom.bloom(jnp.asarray(hdr))),
                               rtol=1e-5, atol=1e-5)


def test_render_sequence_matches_jax_scan():
    scene, cam, cfg = _fused_scene(True)
    poses = _poses(cam, 4)
    jp = JaxPipeline(scene, cfg, use_pallas=True, use_tex_kernel=True, pallas_interpret=True,
                     **FUSED_KNOBS)
    state = jax_state(jp)
    want = np.asarray(jp.render_sequence(poses[:3]))
    want_avg = float(jp.avg_luminance)
    jp.render(poses[3])
    tp = DeferredRenderPipeline(scene, cfg, use_pallas=True, use_tex_kernel=True,
                                device="cpu", **FUSED_KNOBS)
    assert tp.use_fused_gbuffer and tp.use_fused_deferred
    tp.load_state(state_from_jax(state, "cpu"))
    got = tp.render_sequence(poses[:3]).numpy()
    assert got.shape == want.shape == (3, cfg.height, cfg.width, 3) and got.dtype == np.uint8
    for g, w in zip(got, want):
        assert (w.max(-1) > 16).mean() > 0.05   # a non-trivial frame
        assert _rmse(g, w) <= RMSE_BAR
    np.testing.assert_allclose(float(tp.avg_luminance), want_avg, rtol=1e-5)
    tp.render(poses[3])
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats)
    np.testing.assert_allclose(float(tp.avg_luminance), float(jp.avg_luminance), rtol=1e-5)
