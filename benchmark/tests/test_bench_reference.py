"""At 64x48 on the CPU the plain reference renders the frame the port's
all-plain path renders, within the port's own frame bar (rmse 1e-3 on
uint8/255), frame after frame with the exposure carried, and reports the
counters the port's frame reports: the 262,144-triangle terrain scene
with its 8 ring lights under each texture filter, and the 1024-light
scene. The reference's texture counts follow the configuration's filter."""

import json

import numpy as np
import pytest
import torch

from benchmark import cells, program, run
from benchmark.reference import shade
from benchmark.reference.frame import Reference
from benchmark.scenes import stress

BAR = 1e-3


def tiny(name, n_lights, texture_filter=None):
    cfg = json.loads((cells.HERE / "configs" / f"{name}.json").read_text())
    cfg["scene"].update(cells_x=16, cells_y=8, sky_size=16, n_lights=n_lights)
    cfg["render"].update(width=64, height=48)
    cfg["pipeline"].update(brdf_lut_size=16)
    if texture_filter:
        cfg["pipeline"]["texture_filter"] = texture_filter
    return cfg


def ref_cfg(cfg):
    """The reference's configuration as `run.py` hands it over."""
    return {**cfg["render"], **cfg["pipeline"], "fov": program.fov(cfg["render"])}


STREAM = json.loads((cells.HERE / "traffic" / "stream.json").read_text())


@pytest.mark.parametrize("name,n_lights,texture_filter", [
    pytest.param("terrain262k", 8, None, id="terrain262k-8"),
    pytest.param("terrain262k", 8, "bilinear", id="terrain262k-8-bilinear"),
    pytest.param("terrain262k", 8, "anisotropic", id="terrain262k-8-anisotropic"),
    pytest.param("lights1k", 1024, None, id="lights1k-1024")])
def test_reference_matches_the_ports_plain_frame(name, n_lights, texture_filter):
    cfg = tiny(name, n_lights, texture_filter)
    traffic = STREAM
    seed = 2**31 + 99
    data = stress.build(cfg["scene"], seed)
    pipe = program.pipeline(cfg, program.port_scene(data), "cpu", use_pallas=False,
                            use_tex_kernel=False)
    assert pipe.texture_filter == (texture_filter or "trilinear")
    ref = Reference(data, ref_cfg(cfg), "cpu")
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


def test_anisotropic_filter_is_live_at_a_stream_pose():
    """At 64x48 the anisotropic reference's albedo departs from the
    trilinear one on some covered pixels and on no other: the filter does
    work at that size."""
    cfg = tiny("terrain262k", 8)
    data = stress.build(cfg["scene"], 7)
    ref = Reference(data, ref_cfg(cfg), "cpu")
    _, setup, tri_id, _, tris, _, _ = ref._visible(cells.pose(STREAM, 7, 0))
    vattr = ref.vattr[tris]
    tri, _, _, mask = shade.gbuffer(tri_id, setup.edges, vattr, ref.material, ref.albedo)
    ani, _, _, _ = shade.gbuffer(tri_id, setup.edges, vattr, ref.material, ref.albedo,
                                 "anisotropic")
    moved = (tri[..., :3] != ani[..., :3]).any(-1)
    assert bool(mask.any()) and bool(moved[mask].any())
    assert not bool(moved[~mask].any())


def test_unknown_texture_filter_raises():
    cfg = tiny("terrain262k", 8, "point")
    with pytest.raises(ValueError, match="point"):
        Reference(stress.build(cfg["scene"], 3), ref_cfg(cfg), "cpu")


@pytest.mark.parametrize("texture_filter,albedo_map,taps", [
    ("trilinear", True, 1), ("bilinear", True, 1), ("anisotropic", True, 4),
    ("anisotropic", False, 4)])
def test_texture_counts(texture_filter, albedo_map, taps):
    """tex_samples is the covered pixels with the albedo map and 0 without;
    tex_taps is tex_samples times the filter's taps; render's counts and
    `counts` agree, and the other keys do not depend on the filter."""
    cfg = tiny("terrain262k", 8, texture_filter)
    cfg["scene"]["albedo_map"] = albedo_map
    data = stress.build(cfg["scene"], 11)
    pose = cells.pose(STREAM, 11, 3)
    ref = Reference(data, ref_cfg(cfg), "cpu")
    c = ref.counts(pose)
    assert c["tex_samples"] == (c["covered"] if albedo_map else 0)
    assert c["tex_taps"] == taps * c["tex_samples"]
    assert 0 < c["covered"]
    _, _, rc = ref.render(pose, 0.02, STREAM["delta_time"])
    assert rc == {**c, "lit_pairs": rc["lit_pairs"]}
    plain = Reference(data, ref_cfg(tiny("terrain262k", 8)), "cpu").counts(pose)
    assert {k: v for k, v in c.items() if not k.startswith("tex_")} == \
        {k: v for k, v in plain.items() if not k.startswith("tex_")}


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
