"""The port's App (`app/app.py`) against the JAX package's, on the CPU.

* `AppConfig` has the JAX package's fields and defaults, field by field,
  plus `device` (default "cuda"); `main` has every JAX flag plus
  `--device`.
* Both Apps through `main(argv)` on a console-built tree (the quad, three
  spheres, a light, a sky; `test_torch_console.console_tree`, one tree per
  package, byte-equal) at 256x96, tile 24x128, `--frames 2 --out DIR`: each
  prints one JSON line with the same keys, the non-timing ones equal, and
  each PNG frame is within rmse 1e-3 (uint8/255, the JAX package's frame
  bar) of the JAX one. Both packages' pipelines are built with a 32x32 BRDF
  LUT here (the App's 512x512 one takes about 30 s in the port on two CPU
  threads); every other knob is the App's.
* The AppConfig knob set on the kernel path, at a width that pads (200x96
  on a 256-wide canvas): texture caps (92, 44, None, (24, 12)), the cascade
  (12, 8, 0), raster caps (128, 64) with tiles above 128 triangles (the
  two-pass split runs), bin_cap 2048, on a textured 1,024-triangle terrain
  under a sky. The port with `use_pallas=True, use_tex_kernel=True` (each
  kernel's plain version on the CPU) from the JAX pipeline's state, against
  the JAX pipeline in interpret mode: rmse <= 1e-3, every pixel within 1
  LSB, equal FrameStats, and five page covers (three texture, the cascade,
  the env cache). Then the same with both losses the knobs can make
  forced: a hot set of one tile (a cut list, bin_overflow) and a 192^2
  BRDF LUT (the env tap group's fallbacks, env_approx_taps).
* `App` with the default device raises `RuntimeError` without a card, and a
  missing scene raises.
"""

import dataclasses
import json
import math
import re

import numpy as np
import pytest
import torch
from PIL import Image

import direct12pbrrenderer_tpu.pipeline.deferred as jax_deferred
from chip_smoke import recording
from direct12pbrrenderer_tpu.app import app as jax_app
from direct12pbrrenderer_tpu.config import RenderConfig
from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JaxPipeline
from direct12pbrrenderer_tpu.resource import loader as jloader
from direct12pbrrenderer_tpu.resource.resources import CubeMapResource
from direct12pbrrenderer_tpu.scene.camera import Camera
from direct12pbrrenderer_tpu.tools.stress_scene import build_stress_scene
from direct12pbrrenderer_tpu_torch.app import app
from direct12pbrrenderer_tpu_torch.ops import cover_cuda
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.resource import loader as tloader
from direct12pbrrenderer_tpu_torch.state import state_from_jax
from test_env_isolation import _sky_cube
from test_torch_assets import _write_sources
from test_torch_console import console_tree
from test_torch_pipeline import jax_state

torch.set_num_threads(2)
RMSE_BAR = 1e-3
TIMING_KEYS = {"compile_s", "mean_frame_ms", "p50_frame_ms", "fps"}
SMALL = ["--width", "256", "--height", "96", "--frames", "2"]


def small_lut(monkeypatch, module, **knobs):
    """Builds `module.DeferredRenderPipeline` with a 32x32 BRDF LUT (and
    `knobs`)."""
    base = module.DeferredRenderPipeline

    class SmallLut(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "brdf_lut_size": 32, **knobs})

    monkeypatch.setattr(module, "DeferredRenderPipeline", SmallLut)


@pytest.fixture
def loaders_restored():
    old = (jloader.ResourceLoader._instance, tloader.ResourceLoader._instance)
    yield
    jloader.ResourceLoader._instance, tloader.ResourceLoader._instance = old


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    """Both Apps' `main` on their own console-built trees: {pkg: (report,
    stdout lines, PNG directory)}."""
    tmp = tmp_path_factory.mktemp("apps")
    old = (jloader.ResourceLoader._instance, tloader.ResourceLoader._instance)
    src = tmp / "src"
    _write_sources(src)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        small_lut(mp, jax_deferred)
        small_lut(mp, app)
        for pkg, main, extra in (("jax", jax_app.main, []),
                                 ("port", app.main, ["--device", "cpu"])):
            root = console_tree(pkg, src, tmp / pkg)
            out = tmp / f"frames_{pkg}"
            with mp.context() as m2:
                lines = []
                m2.setattr("builtins.print", lambda *a, **k: lines.append(" ".join(map(str, a))))
                report = main(["--asset-root", str(root), *SMALL, "--out", str(out), *extra])
            runs[pkg] = (report, lines, out)
    jloader.ResourceLoader._instance, tloader.ResourceLoader._instance = old
    return runs


def test_app_config_matches_jax_field_by_field():
    jfields = {f.name: f.default for f in dataclasses.fields(jax_app.AppConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(app.AppConfig)}
    assert tfields.pop("device") == "cuda"
    assert list(tfields) == list(jfields)
    assert tfields == jfields


def _flags(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(--[a-z-]+)", capsys.readouterr().out)) - {"--help"}


def test_main_has_every_jax_flag_plus_device(capsys):
    jflags, tflags = _flags(jax_app.main, capsys), _flags(app.main, capsys)
    assert "--tex-budget" in jflags and "--serve" in jflags
    assert tflags == jflags | {"--device"}


def test_main_prints_one_json_line_with_the_jax_keys(app_runs):
    for pkg, (report, lines, _) in app_runs.items():
        assert len(lines) == 1, (pkg, lines)
        assert json.loads(lines[0]) == report
    jrep, trep = app_runs["jax"][0], app_runs["port"][0]
    assert list(trep) == list(jrep)
    assert {k: v for k, v in trep.items() if k not in TIMING_KEYS} == \
        {k: v for k, v in jrep.items() if k not in TIMING_KEYS}
    assert trep["resolution"] == "256x96" and trep["frames"] == 2
    assert trep["visible_instances"] == trep["total_instances"] == 4
    assert trep["visible_lights"] == 1 and trep["bin_overflow"] == 0


def test_app_frames_match_jax_app(app_runs):
    jout, tout = app_runs["jax"][2], app_runs["port"][2]
    names = sorted(p.name for p in tout.iterdir())
    assert names == sorted(p.name for p in jout.iterdir()) == ["frame_0000.png",
                                                               "frame_0001.png"]
    for name in names:
        got = np.asarray(Image.open(tout / name)).astype(np.float64) / 255.0
        want = np.asarray(Image.open(jout / name)).astype(np.float64) / 255.0
        assert got.shape == want.shape == (96, 256, 3)
        assert float(np.sqrt(np.mean((got - want) ** 2))) <= RMSE_BAR, name
        # the spheres and the quad, not only the sky: the centre is lit geometry
        assert not np.array_equal(got[48, 128], got[2, 128])


def _knobs_on_the_kernel_path(**changed):
    """The AppConfig knob set on a textured terrain under a sky at 200x96
    (a 256-wide canvas), with `changed` knobs: the port with `use_pallas=True,
    use_tex_kernel=True` from the JAX pipeline's state, and the JAX pipeline
    in interpret mode. -> (port frame, JAX frame, port pipeline, JAX
    pipeline, the port's recorded page covers)."""
    scene = build_stress_scene(cells_x=32, cells_y=16)
    for sm in scene.models:
        for m in sm.model.materials:
            m.set_parameter("UseAlbedoMap", True)
    sky = CubeMapResource("mem/sky")
    sky.cubemap = _sky_cube(16)
    scene.set_skybox(sky)
    cfg = RenderConfig(width=200, height=96, max_instances=2)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 6, 18])
    cam.rotate(0, math.pi, 0.35)
    d = app.AppConfig()
    knobs = dict(tile_h=d.tile_h, tile_w=d.tile_w, bin_cap=d.bin_cap, tex_caps=d.tex_caps,
                 tex_cascade=d.tex_cascade, raster_caps=d.raster_caps, atlas_max_dim=64,
                 prefilter_size=16, brdf_lut_size=32, use_pallas=True, use_tex_kernel=True)
    knobs.update(changed)
    jp = JaxPipeline(scene, cfg, pallas_interpret=True, **knobs)
    state = jax_state(jp)
    want = np.asarray(jp.render(cam))
    tp = DeferredRenderPipeline(scene, cfg, device="cpu", **knobs)
    assert tp.render_w == jp.render_w == 256 and tp.use_fused_deferred and jp.use_fused_deferred
    tp.load_state(state_from_jax(state, "cpu"))
    with recording(cover_cuda, "fused_cover") as covers:
        got = tp.render(cam).numpy()
    # tiles above cap_small: the two-pass split runs
    assert (_bin_counts(tp, cam) > knobs["raster_caps"][0]).sum() >= 2
    assert got.shape == want.shape == (96, 200, 3)
    return got, want, tp, jp, covers


def test_app_config_knobs_on_the_kernel_path_match_jax():
    d = app.AppConfig()
    assert (d.tex_cascade, d.raster_caps, d.tex_caps[3]) == ((12, 8, 0), (128, 64), (24, 12))
    got, want, tp, jp, covers = _knobs_on_the_kernel_path()
    assert len(covers) == 5 and max(max(a[2]) for a, _ in covers) <= cover_cuda.WIDE_CAP
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert float(np.sqrt(np.mean((got / 255.0 - want / 255.0) ** 2))) <= RMSE_BAR
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats)


def test_app_config_knobs_lose_what_jax_loses():
    """The two losses that the AppConfig knobs can make, forced at 200x96:
    a hot set of one tile (raster_caps (128, 1)), so that tiles beyond it
    fold a cut list (bin_overflow), and a 192^2 BRDF LUT, whose env tap
    group overflows its page cap of 32 (env_approx_taps). Both packages
    lose the same: the same counters and the same frame."""
    got, want, tp, jp, covers = _knobs_on_the_kernel_path(raster_caps=(128, 1),
                                                          brdf_lut_size=192)
    assert tp.last_stats.bin_overflow > 0 and tp.last_stats.env_approx_taps > 0
    assert len(covers) == 5
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert float(np.sqrt(np.mean((got / 255.0 - want / 255.0) ** 2))) <= RMSE_BAR
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats)


def _bin_counts(pipe, cam):
    from direct12pbrrenderer_tpu_torch.pipeline import stages
    from direct12pbrrenderer_tpu_torch.tools.tap_census import _frame_geometry

    setup = _frame_geometry(pipe, cam)[0]
    return stages.binning(setup, pipe.render_w, pipe.render_h, pipe.tile_h, pipe.tile_w,
                          pipe.bin_cap).counts.numpy()


def test_app_without_a_card_or_a_scene_raises(tmp_path, monkeypatch, loaders_restored):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        app.App(app.AppConfig(asset_root=str(tmp_path)))
    with pytest.raises(RuntimeError, match="--device cpu"):
        app.main(["--asset-root", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="main.json"):
        app.App(app.AppConfig(asset_root=str(tmp_path), device="cpu"))


def _counts(stages, pipe, cam, width, height, asarray):
    """Both packages' GBuffer front end at `cam`: the bin counts of the
    pipeline's padded canvas (geometry at the viewport's size)."""
    p = pipe.packed
    planes = cam.frustum_planes()
    setup, _ = stages.geometry(
        pipe.buffers, asarray(p.model_mats),
        asarray(np.ascontiguousarray(np.transpose(p.inv_model_mats[:, :3, :3], (0, 2, 1)))),
        asarray(p.instance_visibility(planes)),
        asarray(np.asarray(cam.projection_matrix() @ cam.view_matrix(), np.float32)),
        width, height)
    return np.asarray(stages.binning(setup, pipe.render_w, pipe.render_h, pipe.tile_h,
                                     pipe.tile_w, pipe.bin_cap).counts)


def _jax_overflow(counts, bin_cap, raster_caps):
    """The JAX pipeline's bin_overflow under use_pallas (its render's rule)."""
    overflow = int(np.maximum(counts - bin_cap, 0).max())
    cap_small, hot_k = raster_caps
    hot_k = min(hot_k, counts.size)
    if int((counts > cap_small).sum()) > hot_k:
        over = np.sort(counts[counts > cap_small])
        overflow = max(overflow, int(np.maximum(over[:-hot_k] - cap_small, 0).max())
                       if hot_k else int((over - cap_small).max()))
    return overflow


def test_app_tree_hot_set_miss_counted_as_in_jax(tmp_path, monkeypatch, loaders_restored):
    """`chip_smoke.py`'s [app] tree T (the console's sky and sphere, the
    stress terrain at 128x64 cells imported from OBJ, 32 spheres, 8 lights)
    at the [app] pose and 1440x960 (the pipelines' precompute cut small):
    both packages' Apps bin the same counts, and under the AppConfig
    raster_caps (128, 64) the hot set misses, more tiles above cap_small
    than hot_k, which the port's FrameStats count as the JAX pipeline
    counts them (bin_overflow > 0): the AppConfig knobs' loss on this tree,
    not the port's."""
    import jax.numpy as jnp

    import chip_smoke
    from direct12pbrrenderer_tpu.pipeline import stages as jax_stages
    from direct12pbrrenderer_tpu_torch.pipeline import stages as port_stages

    tree = tmp_path / "T"
    chip_smoke.app_tree(tree, tmp_path / "src", chip_smoke.APP_CELLS, chip_smoke.APP_GRID)
    # the bins read no precompute: a 32x32 LUT and an 8x8 prefiltered sky
    small_lut(monkeypatch, jax_deferred, prefilter_size=8)
    small_lut(monkeypatch, app, prefilter_size=8)
    tcfg = dataclasses.replace(chip_smoke.app_config(tree), device="cpu")
    jcfg = jax_app.AppConfig(**{k: v for k, v in dataclasses.asdict(tcfg).items()
                                if k != "device"})
    tapp, japp = app.App(tcfg), jax_app.App(jcfg)
    assert (tapp.pipeline.render_w, tapp.pipeline.render_h) == (1536, 960)
    got = _counts(port_stages, tapp.pipeline, tapp.camera, 1440, 960, torch.as_tensor)
    want = _counts(jax_stages, japp.pipeline, japp.camera, 1440, 960, jnp.asarray)
    np.testing.assert_array_equal(got, want)
    cap_small, hot_k = tcfg.raster_caps
    assert (got > cap_small).sum() > hot_k and got.max() <= tcfg.bin_cap
    tapp.pipeline.use_pallas = True          # the card's resolution
    stats = tapp.pipeline._stats(got, np.array([33, 8]), 0, 0, 0)
    assert stats.bin_overflow == _jax_overflow(want, jcfg.bin_cap, jcfg.raster_caps) > 0
