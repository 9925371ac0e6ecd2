"""The port's measurement tools on the CPU.

* `tools/profile.profile_pipeline` returns the stages that
  `tests/test_tools.py` names, in the JAX package's order (bloom after
  deferred_shade when the config enables it), each >= 0 ms, on the plain,
  fused and planar paths of a CPU pipeline; its `main` runs the App's
  configuration on a console-built tree with `--device cpu` and prints the
  JSON line.
* `tools/tap_census.main` on that tree (`test_torch_console.console_tree`,
  one per package, byte-equal) at 256x96 with 2 poses prints the same lines
  and the same final JSON as the JAX package's `main` (fed through
  `sys.argv`). Both Apps are built with a 32x32 BRDF LUT, which the census
  does not read.
"""

import json

import pytest
import torch

import direct12pbrrenderer_tpu.pipeline.deferred as jax_deferred
from direct12pbrrenderer_tpu.resource import loader as jloader
from direct12pbrrenderer_tpu.tools import tap_census as jax_census
from direct12pbrrenderer_tpu_torch.app import app
from direct12pbrrenderer_tpu_torch.resource import loader as tloader
from direct12pbrrenderer_tpu_torch.tools import profile, tap_census
from direct12pbrrenderer_tpu_torch.tools.tiny_scene import tiny_pipeline
from test_torch_app import small_lut
from test_torch_assets import _write_sources
from test_torch_console import console_tree

torch.set_num_threads(2)
# tests/test_tools.py's stages, then the JAX profile's full order
STAGES = ("geometry", "binning", "raster", "gbuffer_shade", "light_cull", "deferred_shade",
          "exposure_tonemap", "full_frame")
ORDER = ("geometry", "binning", "raster", "gbuffer_shade", "light_cull", "deferred_shade",
         "bloom", "exposure_tonemap", "full_frame")


@pytest.fixture
def loaders_restored():
    old = (jloader.ResourceLoader._instance, tloader.ResourceLoader._instance)
    yield
    jloader.ResourceLoader._instance, tloader.ResourceLoader._instance = old


@pytest.mark.parametrize("knobs", [
    dict(width=128, height=96, tile_h=12, tile_w=64),
    dict(width=256, height=96, tile_h=24, tile_w=128, kernels=True),
    dict(width=128, height=96, tile_h=12, tile_w=64, kernels=True),
], ids=["plain", "fused", "planar"])
def test_profile_pipeline_stages(knobs, monkeypatch):
    """The plain path, and with use_pallas and use_tex_kernel on (each
    kernel's plain version on the CPU) the fused path at a 24x128 tile and
    the planar texture cache at 12x64."""
    import direct12pbrrenderer_tpu_torch.tools.tiny_scene as ts

    if knobs.pop("kernels", False):
        base = ts.DeferredRenderPipeline

        class KernelPath(base):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, use_pallas=True, use_tex_kernel=True, **kwargs)

        monkeypatch.setattr(ts, "DeferredRenderPipeline", KernelPath)
    pipe, cam, _ = tiny_pipeline("cpu", **knobs)
    assert pipe.use_fused_deferred == (pipe.use_tex_kernel and knobs["tile_w"] == 128)
    t = profile.profile_pipeline(pipe, cam, iters=1)
    assert tuple(t) == ORDER
    for stage in STAGES:
        assert stage in t and t[stage] >= 0.0, (stage, t)
    assert t["full_frame"] > 0.0


def test_profile_main_on_an_asset_tree(tmp_path, monkeypatch, capsys, loaders_restored):
    src = tmp_path / "src"
    _write_sources(src)
    root = console_tree("port", src, tmp_path / "port")
    small_lut(monkeypatch, app)
    t = profile.main(["--asset-root", str(root), "--width", "128", "--height", "96",
                      "--iters", "1", "--device", "cpu", "--json", str(tmp_path / "t.json")])
    assert tuple(t) == ORDER
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line["timings_ms"]) == list(ORDER)
    assert json.loads((tmp_path / "t.json").read_text())["config"]["device"] == "cpu"


def test_profile_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        profile.main(["--scene", "stress"])


def test_tap_census_main_prints_the_jax_lines(tmp_path, monkeypatch, capsys, loaders_restored):
    src = tmp_path / "src"
    _write_sources(src)
    args = ["--width", "256", "--height", "96", "--poses", "2"]
    small_lut(monkeypatch, jax_deferred)
    small_lut(monkeypatch, app)
    root = console_tree("jax", src, tmp_path / "jax")
    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["tap_census", "--asset-root", str(root), *args])
    jax_census.main()
    want = capsys.readouterr().out.strip().splitlines()
    root = console_tree("port", src, tmp_path / "port")
    capsys.readouterr()
    result = tap_census.main(["--asset-root", str(root), *args, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert got == want
    assert json.loads(got[-1]) == result
    assert len(got) == 3 and result["poses"] == 2 and result["env_budget"] is None
    assert result["cap_lo"] > 0 and result["stage_budget"] > 0
    assert "lo max=0 " not in got[0]      # the first pose samples the quad's maps
