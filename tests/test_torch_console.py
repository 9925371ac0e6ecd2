"""The port's asset-import console (`app/console.py`) against the JAX
package's, on the CPU.

* Every command (ImportModel, ImportTexture at both BC6H qualities,
  ImportCubeMap, CreateSphereModel, CreateProceduralSky,
  GenerateIrradianceMap) through each package's `main(argv)` into its own
  root: the two trees hold the same files with the same bytes, the
  irradiance `.hdr` faces included.
* `repl` driven through stdin, a bad command included: the same lines as
  the JAX console's.
* `utils/sh.eval_irradiance` and `generate_irradiance_map` equal the JAX
  package's on a random cubemap.

`console_tree` builds the small asset tree that the App, tools and bench
tests render (`tests/test_torch_app.py`, `test_torch_tools.py`,
`test_torch_bench.py`, `test_torch_no_jax.py`) with a package's console.
"""

import importlib
import io

import numpy as np
import pytest

from direct12pbrrenderer_tpu.resource import loader as jloader
from direct12pbrrenderer_tpu.utils import sh as jsh
from direct12pbrrenderer_tpu_torch.resource import loader as tloader
from direct12pbrrenderer_tpu_torch.utils import sh as tsh
from test_torch_assets import PACKAGES, _files, _write_sources


def _console(pkg):
    return importlib.import_module(f"{PACKAGES[pkg]}.app.console")


def console_tree(pkg, src, root):
    """A tree built with package `pkg`'s console from `_write_sources`'
    files: the textured quad (ImportModel), the sphere (CreateSphereModel), a
    16^2 procedural sky, and a Scene JSON at the App's default scene path
    with the quad behind three spheres, one light and the sky, all in front
    of the App's default camera ((0, 3, 10), yaw 180)."""
    console = _console(pkg)
    scene_mod = importlib.import_module(f"{PACKAGES[pkg]}.scene.scene")
    r = ["--asset-root", str(root)]
    console.main(r + ["ImportModel", "-i", str(src / "quad.obj"), "-o", "Asset/Quad/Quad",
                      "-s", "2"])
    console.main(r + ["CreateSphereModel", "-o", "Asset/Model/Sphere"])
    console.main(r + ["CreateProceduralSky", "-s", "16", "-o", "Asset/SkyBox/Sky"])
    scene = scene_mod.Scene("Asset/Scene/main")
    quad = scene_mod.SceneModel("quad")
    quad.model_file_path = "Asset/Quad/Quad_Model"
    quad.translation = np.array([0.0, 3.0, -2.0], np.float32)
    quad.rotation = np.array([0.0, 180.0, 0.0], np.float32)   # its face to the camera
    scene.add_model(quad)
    for i, x in enumerate((-2.5, 0.0, 2.5)):
        sm = scene_mod.SceneModel(f"ball{i}")
        sm.model_file_path = "Asset/Model/Sphere/sphere_Model"
        sm.translation = np.array([x, 3.0, 0.0], np.float32)
        scene.add_model(sm)
    light = scene_mod.SceneLight("key")
    light.translation = np.array([2.0, 5.0, 6.0], np.float32)
    light.set_intensity(60.0)
    light.set_radius(12.0)
    scene.add_light(light)
    scene.skybox_path = "Asset/SkyBox/Sky"
    importlib.import_module(f"{PACKAGES[pkg]}.resource.loader").ResourceLoader.instance() \
        .dump_resource(scene)
    return root


@pytest.fixture
def loaders_restored():
    old = (jloader.ResourceLoader._instance, tloader.ResourceLoader._instance)
    yield
    jloader.ResourceLoader._instance, tloader.ResourceLoader._instance = old


def _hdr_texture(path):
    from direct12pbrrenderer_tpu_torch.resource.hdr import save_hdr

    rng = np.random.default_rng(1)
    save_hdr(path, (rng.random((16, 16, 3)) * 6.0).astype(np.float32))


def test_every_command_writes_the_jax_tree(tmp_path, capsys, loaders_restored):
    src = tmp_path / "src"
    _write_sources(src)
    _hdr_texture(src / "glow.hdr")
    printed = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        console_tree(pkg, src, root)
        r = ["--asset-root", str(root)]
        main = _console(pkg).main
        main(r + ["ImportTexture", "-i", str(src / "checker.png"), "-o", "Asset/Tex/Checker"])
        main(r + ["ImportTexture", "-i", str(src / "glow.hdr"), "-o", "Asset/Tex/Glow",
                  "--hdr-quality", "high"])
        main(r + ["ImportCubeMap", "-i", str(src / "cube"), "-o", "Asset/SkyBox/Faces"])
        main(r + ["GenerateIrradianceMap", "-i", "Asset/SkyBox/Sky", "-o",
                  str(root / "Irradiance"), "-s", "8"])
        printed[pkg] = capsys.readouterr().out.replace(str(root), "ROOT")
        # the import restores the default BC6H quality
        assert importlib.import_module(f"{PACKAGES[pkg]}.resource.bc").BC6H_QUALITY_DEFAULT \
            == "fast"
    assert printed["port"] == printed["jax"]
    assert len(printed["port"].splitlines()) == 7
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(tfiles) == sorted(jfiles)
    assert {f"Irradiance/{n}.hdr" for n in ("px", "nx", "py", "ny", "pz", "nz")} <= set(tfiles)
    assert {"Asset/Tex/Glow_data.bin", "Asset/SkyBox/Faces_data.bin", "Asset/Scene/main.json",
            "Asset/Model/Sphere/sphere_Mesh_data.bin"} <= set(tfiles)
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name


def test_repl_reads_stdin_like_jax(tmp_path, monkeypatch, capsys, loaders_restored):
    lines = ("CreateSphereModel -o Asset/S\n\nNoSuchCommand -x 1\nCreateProceduralSky -s 8 "
             "-o Asset/Sky\nCreateSphereModel\nquit\nCreateSphereModel -o Asset/After\n")
    out = {}
    for pkg in PACKAGES:
        monkeypatch.setattr("sys.stdin", io.StringIO(lines))
        _console(pkg).main(["--asset-root", str(tmp_path / pkg), "repl"])
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert out["port"].splitlines() == [
        "console ready (ImportModel/ImportTexture/ImportCubeMap/CreateSphereModel/"
        "GenerateIrradianceMap/CreateProceduralSky; quit to exit)",
        "created Asset/S/sphere_Model", "bad command",
        "created procedural sky -> Asset/Sky (SH baked)", "bad command"]
    assert (tmp_path / "port" / "Asset" / "Sky.json").exists()
    assert not (tmp_path / "port" / "Asset" / "After").exists()   # after quit


def test_repl_refuses_a_nested_repl(tmp_path, monkeypatch, capsys, loaders_restored):
    monkeypatch.setattr("sys.stdin", io.StringIO("repl\nCreateSphereModel -o Asset/S\n"))
    _console("port").main(["--asset-root", str(tmp_path), "repl"])
    assert capsys.readouterr().out.splitlines()[1:] == ["bad command",
                                                        "created Asset/S/sphere_Model"]


class _Cube:
    def __init__(self, faces):
        self.faces = faces

    def face_arrays(self, mip):
        return self.faces


@pytest.mark.parametrize("size", [4, 9])
def test_irradiance_matches_jax(size):
    rng = np.random.default_rng(size)
    cube = _Cube((rng.random((6, 16, 16, 4)) * 3.0).astype(np.float32))
    want = jsh.generate_irradiance_map(cube, size)
    got = tsh.generate_irradiance_map(cube, size)
    assert got.shape == (6, size, size, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    pack = jsh.generate_sh_coefficients(cube)
    normals = rng.normal(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsh.eval_irradiance(tsh.SH2CoefficientsPack.from_array(
        pack.as_array()), normals), jsh.eval_irradiance(pack, normals))
