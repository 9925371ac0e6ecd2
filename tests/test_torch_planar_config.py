"""The benchmark's `terrain_planar` configuration on the CPU, held to the plain
reference at three `stream` poses (`tests/torch_config_cells.py`) on the
CPU's and the card's paths. On the card's knobs (kernel A's planes at the
160-wide tile, the planar texture cache, the env cache) a traced frame's
`tex_taps` is the reference's count at its pose, and kernel E's span
`gbuffer.atlas_resolve` is recorded once a frame inside
`gbuffer.tex_resolve`, which the fused path never records.

The configuration is cut to 160x48, one row of its 24x160 raster tiles wide
and two high.
"""

import pytest
import torch

from benchmark import cells, program
from benchmark.scenes import stress
from torch_config_cells import PATHS, config, hold_to_reference, traffic

torch.set_num_threads(2)

SEED = 2**31 + 6007
SPAN = "gbuffer.atlas_resolve"


def _resolve_spans(frame):
    """[(depth, parent name)] of the frame's `gbuffer.atlas_resolve` spans."""
    spans = frame.spans
    return [(depth, spans[parent][0]) for name, _, _, parent, depth in spans if name == SPAN]


@pytest.mark.parametrize("path", list(PATHS))
def test_terrain_planar_matches_the_reference(path):
    cfg = config("terrain_planar", 160)
    assert (cfg["pipeline"]["tile_h"], cfg["pipeline"]["tile_w"]) == (24, 160)
    pipe, tr, want = hold_to_reference(cfg, path, SEED)
    assert not pipe.use_fused_gbuffer
    assert pipe.use_tex_kernel == (path == "card")
    assert want["tex_taps"] == want["tex_samples"] > 0
    # the plans count their taps: the CPU's direct-atlas sampler plans none
    assert pipe.last_stats.tex_taps == (want["tex_taps"] if path == "card" else 0)
    frames = tr.frames[-2:]
    assert len(frames) == 2
    for frame in frames:
        assert _resolve_spans(frame) == ([(3, "gbuffer.tex_resolve")] if path == "card" else [])


def test_the_fused_path_records_no_atlas_resolve():
    # the same deployment at a 128-wide raster tile passes the fused
    # G-buffer's gate: its texture cache resolves in kernel C, not E
    cfg = config("terrain_planar", 128)
    cfg["pipeline"].update(tile_w=128)
    tr = traffic()
    data = stress.build(cfg["scene"], SEED)
    pipe = program.pipeline(cfg, program.port_scene(data), "cpu", **PATHS["card"])
    assert pipe.use_fused_gbuffer
    pipe.start_trace()
    pipe.render(program.camera(cfg, cells.pose(tr, SEED, 0)), tr["delta_time"])
    frame = pipe.stop_trace().frames[-1]
    assert "gbuffer.tex_resolve" in [s[0] for s in frame.spans]
    assert _resolve_spans(frame) == []
