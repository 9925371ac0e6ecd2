"""At 64x48 on the CPU the plain reference renders the frame the port's
all-plain path renders, within the port's own frame bar (rmse 1e-3 on
uint8/255), frame after frame with the exposure carried, and reports the
counters the port's frame reports: the 262,144-triangle terrain scene
with its 8 ring lights and the 1024-light scene."""

import json

import numpy as np
import pytest
import torch

from benchmark import cells, program, run
from benchmark.reference.frame import Reference
from benchmark.scenes import stress

BAR = 1e-3


def tiny(name, n_lights):
    cfg = json.loads((cells.HERE / "configs" / f"{name}.json").read_text())
    cfg["scene"].update(cells_x=16, cells_y=8, sky_size=16, n_lights=n_lights)
    cfg["render"].update(width=64, height=48)
    cfg["pipeline"].update(brdf_lut_size=16)
    return cfg


@pytest.mark.parametrize("name,n_lights", [("terrain262k", 8), ("lights1k", 1024)])
def test_reference_matches_the_ports_plain_frame(name, n_lights):
    cfg = tiny(name, n_lights)
    traffic = json.loads((cells.HERE / "traffic" / "stream.json").read_text())
    seed = 2**31 + 99
    data = stress.build(cfg["scene"], seed)
    pipe = program.pipeline(cfg, program.port_scene(data), "cpu", use_pallas=False,
                            use_tex_kernel=False)
    ref = Reference(data, {**cfg["render"], **cfg["pipeline"],
                           "fov": program.fov(cfg["render"])}, "cpu")
    dt = traffic["delta_time"]
    for k in range(3):
        pose = cells.pose(traffic, seed, k)
        prev = float(pipe.avg_luminance)
        got = pipe.render(program.camera(cfg, pose), dt).numpy()
        want, avg, counts = ref.render(pose, prev, dt)
        d = (got.astype(np.float64) - want.numpy()) / 255.0
        assert np.sqrt(np.mean(d * d)) <= BAR
        assert float(avg) == pytest.approx(float(pipe.avg_luminance), rel=1e-6)
        assert counts["visible_lights"] == pipe.last_stats.visible_lights
        assert ref.stats(pose) == {k: getattr(pipe.last_stats, k) for k in run.STATS}
        assert counts == {**ref.counts(pose), "lit_pairs": counts["lit_pairs"]}
        assert 0 < counts["covered"] < counts["pixels"]


def test_bfloat16_reference_moves_the_frame():
    """The control: the reference's lighting in bfloat16 departs from the
    float32 reference by more than the float32 reference departs from the
    port."""
    cfg = tiny("lights1k", 1024)
    data = stress.build(cfg["scene"], 5)
    rc = {**cfg["render"], **cfg["pipeline"], "fov": program.fov(cfg["render"])}
    traffic = json.loads((cells.HERE / "traffic" / "stream.json").read_text())
    pose = cells.pose(traffic, 5, 0)
    a = Reference(data, rc, "cpu").render(pose, 0.02, traffic["delta_time"])[0].numpy()
    b = Reference(data, rc, "cpu", dtype=torch.bfloat16).render(
        pose, 0.02, traffic["delta_time"])[0].numpy()
    d = (a.astype(np.float64) - b) / 255.0
    assert np.sqrt(np.mean(d * d)) > 5e-4
