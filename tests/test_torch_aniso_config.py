"""The benchmark's `terrain_aniso` configuration on the CPU, held to the plain
reference at three `stream` poses (`tests/torch_config_cells.py`) on the
CPU's and the card's paths; a traced frame's `tex_taps` is the reference's
count at its pose, four taps a sample.

The configuration is cut to 128x48, one row of its 24x128 tiles wide.
"""

import pytest
import torch

from torch_config_cells import PATHS, config, hold_to_reference

torch.set_num_threads(2)

SEED = 2**31 + 4093


@pytest.mark.parametrize("path", list(PATHS))
def test_terrain_aniso_matches_the_reference(path):
    cfg = config("terrain_aniso", 128)
    assert cfg["pipeline"]["texture_filter"] == "anisotropic"
    pipe, _, want = hold_to_reference(cfg, path, SEED)
    assert pipe.texture_filter == "anisotropic" and not pipe.use_fused_gbuffer
    assert want["tex_taps"] == 4 * want["tex_samples"] > 0
    assert pipe.last_stats.tex_taps == want["tex_taps"]
