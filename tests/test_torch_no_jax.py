"""The port imports torch and never jax, nor any module of the JAX package:
it keeps its own copies of the host modules it needs.

tests/conftest.py imports jax into the test process, so the frames (the
default path on an accelerator, the 1024-light path and the planar
texture-cache path) are rendered in a fresh interpreter from the port's own
scene and camera, which then reports whether jax or the JAX package was ever
imported; the bench's smoke run, the App's command line on a console-built
tree, the asset loader, the census tools and the native library, and the
measurement checklist's command line are imported the same way.
"""

import json
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "direct12pbrrenderer_tpu_torch"

_SCRIPT = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.resource.default_meshes import sphere_mesh
from direct12pbrrenderer_tpu_torch.resource.resources import (MaterialResource, MeshResource,
                                                              ModelResource)
from direct12pbrrenderer_tpu_torch.scene.camera import Camera
from direct12pbrrenderer_tpu_torch.scene.scene import Scene, SceneLight, SceneModel
from direct12pbrrenderer_tpu_torch.tools.stress_scene import build_stress_scene
import direct12pbrrenderer_tpu_torch.state  # noqa: F401
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

mesh = MeshResource("mem/sphere", "mem/sphere_data")
mesh.mesh = sphere_mesh(1.0, 12, 8)
mat = MaterialResource("mem/mat")
mat.set_parameter("Albedo", np.array([0.8, 0.3, 0.2], np.float32))
model = ModelResource("mem/model", mesh, [mat])
scene = Scene("mem/scene")
sm = SceneModel("ball")
sm.set_model(model)
sm.update_transform()
scene.add_model(sm)
light = SceneLight("key")
light.translation = np.array([2.0, 2.0, 3.0], np.float32)
light.update_transform()
light.set_intensity(60.0)
light.set_radius(4.0)
scene.add_light(light)
cfg = RenderConfig(width=64, height=48, max_triangles=1024, max_vertices=1024,
                   max_instances=2, max_lights=4)
pipe = DeferredRenderPipeline(scene, cfg, tile_h=12, tile_w=64, bin_cap=256,
                              prefilter_size=8, brdf_lut_size=16, use_pallas=True,
                              device="cpu")
cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
cam.move([0, 0, 4])
cam.rotate(0, np.pi, 0)
img = pipe.render(cam).numpy()
assert img.shape == (48, 64, 3) and (img.max(-1) > 16).mean() > 0.05
# the default path on an accelerator: texture and env caches, kernels A-D
cfg = RenderConfig(width=128, height=48, max_triangles=1024, max_vertices=1024,
                   max_instances=2, max_lights=4)
pipe = DeferredRenderPipeline(scene, cfg, tile_h=24, tile_w=128, bin_cap=256,
                              prefilter_size=8, brdf_lut_size=16, use_pallas=True,
                              use_tex_kernel=True, device="cpu")
assert pipe.use_fused_deferred
cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
cam.move([0, 0, 4])
cam.rotate(0, np.pi, 0)
img = pipe.render(cam).numpy()
assert img.shape == (48, 128, 3) and (img.max(-1) > 16).mean() > 0.05
# the same with kernel D's bfloat16 light loop
pipe = DeferredRenderPipeline(scene, cfg, tile_h=24, tile_w=128, bin_cap=256,
                              prefilter_size=8, brdf_lut_size=16, use_pallas=True,
                              use_tex_kernel=True, fused_light_dtype="bfloat16", device="cpu")
img = pipe.render(cam).numpy()
assert img.shape == (48, 128, 3) and (img.max(-1) > 16).mean() > 0.05
# the 1024-light path: fused G-buffer, env cache (kernels B, F), tiled lights (G)
scene = build_stress_scene(cells_x=8, cells_y=4, n_lights=72)
cfg = RenderConfig(width=128, height=48, max_instances=2, max_lights=128)
pipe = DeferredRenderPipeline(scene, cfg, tile_h=24, tile_w=128, bin_cap=256,
                              prefilter_size=8, brdf_lut_size=16, max_active_lights=128,
                              atlas_max_dim=64, use_pallas=True, use_tex_kernel=True,
                              device="cpu")
assert pipe.light_tile == (24, 128) and not pipe.use_fused_deferred
cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
cam.move([0, 4, 10])
cam.rotate(0, np.pi, 0.3)
img = pipe.render(cam).numpy()
assert img.shape == (48, 128, 3) and (img.max(-1) > 16).mean() > 0.05
assert pipe.last_stats.visible_lights > 32
# the planar texture-cache path: kernel A's planes at a 24x64 tile, the
# cache on its own tiling (kernels B, E), the env cache (B, F)
for sm in scene.models:
    for m in sm.model.materials:
        m.set_parameter("UseAlbedoMap", True)
cfg = RenderConfig(width=128, height=48, max_instances=2, max_lights=16)
pipe = DeferredRenderPipeline(scene, cfg, tile_h=24, tile_w=64, bin_cap=256,
                              prefilter_size=8, brdf_lut_size=16, atlas_max_dim=64,
                              use_pallas=True, use_tex_kernel=True, device="cpu")
assert pipe.use_tex_kernel and not pipe.use_fused_gbuffer
img = pipe.render(cam).numpy()
assert img.shape == (48, 128, 3) and (img.max(-1) > 16).mean() > 0.05
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "direct12pbrrenderer_tpu"))
print("imported:", bad)
"""


def test_port_renders_without_importing_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "imported: []", proc.stdout


def test_bench_smoke_runs_without_importing_jax():
    # -X importtime lists every module the interpreter imports, from startup on
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m",
                           "direct12pbrrenderer_tpu_torch.bench", "--smoke", "--device", "cpu",
                           "--frames", "2"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["value"] > 0
    imported = [line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert "direct12pbrrenderer_tpu_torch.tools.tiny_scene" in imported   # the bench's own
    assert [m for m in imported if m.split(".")[0] in ("jax", "direct12pbrrenderer_tpu")] == []


def test_package_sources_name_no_jax():
    # `\b` does not end a name before "_torch": the port's own imports pass
    pat = re.compile(r"^\s*(import|from) (jax|direct12pbrrenderer_tpu)\b", re.M)
    sources = [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources if pat.search(p.read_text())]
    assert offenders == []
    # the App, its console and viewer, and the tools are among the files read
    names = {p.relative_to(PACKAGE).as_posix() for p in sources if PACKAGE in p.parents}
    assert {"app/__init__.py", "app/__main__.py", "app/app.py", "app/console.py",
            "app/viewer.py", "tools/profile.py", "tools/tap_census.py", "tools/checklist.py",
            "parallel/__init__.py", "parallel/frame_sharded.py"} <= names
    # every kernel wrapper launches or raises: no fallback to the plain version
    for name in ("raster_cuda", "cover_cuda", "resolve_shade_cuda", "shade_fused",
                 "lights_cuda", "env_resolve_cuda", "atlas_resolve_cuda", "cover_two"):
        assert "except" not in (PACKAGE / "ops" / f"{name}.py").read_text(), name
    # the bench and its helpers, the census and the asset path let every
    # failure through (a missing blob is an explicit check, not a handler)
    for path in ("bench.py", "app/app.py", "app/__main__.py", "tools/profile.py",
                 "tools/tiny_scene.py", "utils/fidelity.py",
                 "tools/tap_census.py", "pipeline/deferred.py", "resource/loader.py",
                 "resource/bc.py", "resource/native_codec.py", "resource/resources.py",
                 "resource/serialization.py", "resource/reflection_def.py",
                 "resource/hdr.py", "resource/storage.py", "scene/scene.py",
                 "native/__init__.py", "utils/tlsf.py", "utils/octree.py",
                 "parallel/frame_sharded.py", "tools/checklist.py"):
        assert "except" not in (PACKAGE / path).read_text(), path
    # the thread pool's one handler hands a task's exception to its future
    threading_src = (PACKAGE / "utils" / "threading.py").read_text()
    assert re.findall(r"^\s*except\b.*$", threading_src, re.M) == [
        "            except BaseException as e:  # noqa: BLE001 — propagate via future"]
    # the console's REPL takes argparse's exit on a bad line; the viewer reads
    # a malformed input body as no input and stops on an interrupt
    handlers = {name: re.findall(r"^\s*except\b.*$", (PACKAGE / "app" / name).read_text(), re.M)
                for name in ("console.py", "viewer.py")}
    assert handlers == {
        "console.py": ["            except SystemExit:  # argparse has printed the usage error"],
        "viewer.py": ["            except json.JSONDecodeError:",
                      "    except KeyboardInterrupt:"]}


def test_loader_and_census_import_without_jax():
    # the asset path, the census tools and the native library, from a fresh
    # interpreter: -X importtime lists every module imported from startup on
    code = ("import direct12pbrrenderer_tpu_torch.resource.loader, "
            "direct12pbrrenderer_tpu_torch.tools.tap_census, "
            "direct12pbrrenderer_tpu_torch.utils.threading; "
            "from direct12pbrrenderer_tpu_torch.utils.tlsf import TlsfAllocator; "
            "print(TlsfAllocator(4096).alloc(100))")
    proc = subprocess.run([sys.executable, "-X", "importtime", "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "0"
    imported = [line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert "direct12pbrrenderer_tpu_torch.resource.reflection_def" in imported
    assert "direct12pbrrenderer_tpu_torch.native" in imported
    assert [m for m in imported if m.split(".")[0] in ("jax", "direct12pbrrenderer_tpu")] == []


def test_band_frame_imports_without_jax():
    # the band frame and its launcher, from a fresh interpreter
    code = ("from direct12pbrrenderer_tpu_torch.parallel import frame_sharded; "
            "from direct12pbrrenderer_tpu_torch.tools.tiny_scene import dryrun_multichip; "
            "print(frame_sharded.backend_for(2, 'cpu'))")
    proc = subprocess.run([sys.executable, "-X", "importtime", "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "gloo"
    imported = [line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert "direct12pbrrenderer_tpu_torch.parallel.frame_sharded" in imported
    assert "direct12pbrrenderer_tpu_torch.tools.tiny_scene" in imported
    assert [m for m in imported if m.split(".")[0] in ("jax", "direct12pbrrenderer_tpu")] == []


_APP_MAIN = r"""
import runpy
import sys
import torch
torch.set_num_threads(2)
from direct12pbrrenderer_tpu_torch.app import app

class SmallLut(app.DeferredRenderPipeline):   # the App's 512x512 LUT takes ~30 s here
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **{**kwargs, "brdf_lut_size": 32})

app.DeferredRenderPipeline = SmallLut
sys.argv = ["direct12pbrrenderer_tpu_torch.app", *sys.argv[1:]]
runpy.run_module("direct12pbrrenderer_tpu_torch.app", run_name="__main__", alter_sys=True)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "direct12pbrrenderer_tpu"))
print("imported:", bad)
"""


def test_app_command_line_runs_without_importing_jax(tmp_path):
    from direct12pbrrenderer_tpu_torch.resource import loader as tloader
    from test_torch_assets import _write_sources
    from test_torch_console import console_tree

    old = tloader.ResourceLoader._instance
    _write_sources(tmp_path / "src")
    root = console_tree("port", tmp_path / "src", tmp_path / "tree")
    tloader.ResourceLoader._instance = old
    proc = subprocess.run([sys.executable, "-X", "importtime", "-c", _APP_MAIN, "--asset-root",
                           str(root), "--width", "64", "--height", "48", "--frames", "2",
                           "--out", str(tmp_path / "frames"), "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    *_, report, imported = proc.stdout.strip().splitlines()
    assert imported == "imported: []", proc.stdout
    report = json.loads(report)
    assert report["resolution"] == "64x48" and report["frames"] == 2
    assert sorted(p.name for p in (tmp_path / "frames").iterdir()) == ["frame_0000.png",
                                                                       "frame_0001.png"]
    modules = [line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
               if line.startswith("import time:")]
    assert {"direct12pbrrenderer_tpu_torch.app.app",
            "direct12pbrrenderer_tpu_torch.utils.threading"} <= set(modules)
    assert [m for m in modules if m.split(".")[0] in ("jax", "direct12pbrrenderer_tpu")] == []


def test_checklist_command_line_imports_without_jax(tmp_path):
    # the checklist as a user runs it, from a fresh interpreter, on a path
    # that holds no asset tree: it imports the App and the pipeline, then
    # stops with its message
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m",
                           "direct12pbrrenderer_tpu_torch.tools.checklist", "--asset-root",
                           str(tmp_path), "--device", "cpu"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 2 and "--asset-root must name an asset tree" in proc.stderr
    imported = [line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert "direct12pbrrenderer_tpu_torch.app.app" in imported
    assert "direct12pbrrenderer_tpu_torch.pipeline.deferred" in imported
    assert [m for m in imported if m.split(".")[0] in ("jax", "direct12pbrrenderer_tpu")] == []
