"""The port's band frame (`parallel/frame_sharded.py`) on every path, on
gloo ranks with `device="cpu"` (the kernels' plain versions), the inputs
made with numpy from fixed seeds.

* One `launch` of 2 ranks renders the sky scene at 256x96 in 48-row bands
  on the default path's knobs (FUSED_KNOBS: the fused G-buffer and
  deferred pass) and on every other single-card path
  (`tests/test_torch_frame_graph.py::PATHS`: lights1k, planar-tex,
  anisotropic, `use_tex_kernel=False`, all-plain). On each path, after one
  warm-up band frame whose exposure carry the second frame takes on the
  device:
  - the gathered second frame equals the port's `render()` of the same
    pose from the same carry bit for bit, with equal `collect_stats`
    outputs (bin counts in band order, fallback taps, light-tile
    truncation) and an equal carry, on every rank;
  - the second frame makes no host read and makes no tensor from host
    data (`tests/torch_host_reads.py`'s `no_host_reads`): on a card these
    are what a CUDA graph capture of the band frame refuses.
* The exposure carry chained on the device over three poses on the plain
  path, at `test_pad_to_tile_bands_match_jax_sharded_frame`'s setup (4
  ranks, 128x120, 30-row bands on 36-row canvases), against the JAX band
  frame's chained carry within rtol 1e-5 (that test's bar for one frame).
"""

import math

import jax
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.config import RenderConfig
from direct12pbrrenderer_tpu.parallel import frame_sharded as jfs
from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JaxPipeline
from direct12pbrrenderer_tpu.scene.camera import Camera
from direct12pbrrenderer_tpu_torch.parallel import frame_sharded
from test_pipeline import build_scene
from test_sharded import _sharded_args
from test_torch_frame_graph import PATHS
from test_torch_pipeline import FUSED_KNOBS, _fused_scene, _poses, jax_state
from torch_band_ranks import band_carry, band_paths

torch.set_num_threads(2)
# every single-card path: the default one and PATHS, over FUSED_KNOBS
BAND_PATHS = {"default": dict(use_pallas=True, use_tex_kernel=True), **PATHS}
STATS = ("avg", "bin_counts", "tex_approx", "light_trunc", "env_approx")


@pytest.fixture(scope="module")
def band_runs():
    scene, cam, cfg = _fused_scene(True)
    paths = {name: dict(FUSED_KNOBS, **knobs) for name, knobs in BAND_PATHS.items()}
    return frame_sharded.launch(2, band_paths, scene, cfg, paths, _poses(cam, 2),
                                device="cpu")


@pytest.mark.parametrize("path", list(BAND_PATHS))
def test_band_frame_equals_render(band_runs, path):
    want = band_runs[0][path]["render"]
    assert (want[0].max(-1) > 16).mean() > 0.05   # a non-trivial frame
    for rank in band_runs:
        got = rank[path]["band"]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].shape == ()   # the carry is a scalar
        for name, g, w in zip(STATS, got[1:], want[1:]):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("path", list(BAND_PATHS))
def test_band_frame_makes_no_host_read(band_runs, path):
    for rank in band_runs:
        assert rank[path]["host_reads"] == []


def test_band_carry_chained_on_device_matches_jax():
    cfg = RenderConfig(width=128, height=120, max_triangles=2048, max_vertices=2048,
                       max_instances=4, max_lights=16)
    knobs = dict(tile_h=12, tile_w=64, bin_cap=512, prefilter_size=16, brdf_lut_size=32)
    jp = JaxPipeline(build_scene(), cfg, **knobs)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    cam.rotate(0, math.pi, 0.0)
    poses = _poses(cam, 3)
    state = jax_state(jp)
    frame = jfs.build_sharded_frame(jfs.make_mesh(4), jp)
    want, avg = [], jax.numpy.asarray(0.0, jax.numpy.float32)
    for c in poses:
        args = _sharded_args(jp, c)
        avg = frame(*args[:-2], avg, args[-1])[1]
        want.append(float(avg))
    assert len(set(want)) == 3   # the carry moves from pose to pose
    res = frame_sharded.launch(4, band_carry, jp.scene, cfg, knobs, state, poses, device="cpu")
    for got in res:
        assert all(a.shape == () for a in got)
        np.testing.assert_allclose(np.stack(got), want, rtol=1e-5)
