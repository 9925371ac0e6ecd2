"""The kernels' build keys (`kernels/build.py`), on the CPU: a library is
keyed on its `.cu` source and every local header that source includes,
transitively, so an edit to a shared header rebuilds exactly the kernels
that use it. No CUDA compiler is run: the first-use test stands a script
that links an empty library with g++ in for nvcc, and checks that a first
use from many threads at once (the viewer renders on its HTTP handler
threads) builds once and hands every thread the same library.

The kernel seam (`kernels/launch.py`), with every module of the package
imported: each source is declared by at least one entry and each entry
names a source; no module under ops/, pipeline/, parallel/ or utils/ loads
a library itself; no module keeps a launch counter of its own."""

import ast
import importlib
import pkgutil
import shutil
import threading

import pytest

import direct12pbrrenderer_tpu_torch as port
from direct12pbrrenderer_tpu_torch.kernels import build, launch

SOURCES = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
# the kernels launched on a persistent grid (csrc/persistent_grid.cuh):
# A and H through raster_fold.cuh, B directly
PERSISTENT = ("fused_cover", "raster_depth", "raster_interp")
# each shared header and the kernels that include it: the in-place plane
# reads of C and D, the texture tap body of C and E (whose corner blend the
# anisotropic sampler shares), the env tap body of D and F
SHARED = {"tap_planes.cuh": ("deferred_shade", "resolve_shade"),
          "tex_resolve.cuh": ("aniso_sample", "atlas_resolve", "resolve_shade"),
          "env_resolve.cuh": ("deferred_shade", "env_resolve"),
          "persistent_grid.cuh": PERSISTENT}


@pytest.mark.parametrize("name", SOURCES)
def test_source_files_exist(name):
    files = build.source_files(name)
    assert files[0] == build.CSRC_DIR / f"{name}.cu"
    assert len(set(files)) == len(files)
    assert all(f.is_file() for f in files)


@pytest.mark.parametrize("name", PERSISTENT)
def test_persistent_kernels_include_the_grid_header(name):
    assert build.CSRC_DIR / "persistent_grid.cuh" in build.source_files(name)


def test_header_edit_rekeys_only_its_users(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {name: build.library_path(name) for name in SOURCES}
    with open(csrc / "persistent_grid.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: build.library_path(name) for name in SOURCES}
    assert {n for n in SOURCES if before[n] != after[n]} == set(PERSISTENT)


@pytest.mark.parametrize("header", sorted(SHARED))
def test_shared_header_edit_rekeys_exactly_its_users(header, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    assert {n for n in SOURCES if csrc / header in build.source_files(n)} == set(SHARED[header])
    before = {name: build.library_path(name) for name in SOURCES}
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    after = {name: build.library_path(name) for name in SOURCES}
    assert {n for n in SOURCES if before[n] != after[n]} == set(SHARED[header])


def test_first_use_from_many_threads_builds_once(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(f"""#!/bin/sh
echo "$$" >> {calls}
sleep 0.3
while [ "$1" != "-o" ]; do shift; done
exec g++ -shared -fPIC -x c /dev/null -o "$2"
""")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LOADED", {})
    n = 8
    barrier = threading.Barrier(n)
    libs, errors = [], []

    def first_use():
        barrier.wait()
        try:
            libs.append(build.load("fused_cover"))
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(libs) == n
    assert all(lib is libs[0] for lib in libs)
    assert len(calls.read_text().splitlines()) == 1
    assert sorted(build.BUILD_DIR.iterdir()) == [build.library_path("fused_cover")]


def _declared_sources(modules):
    declared = {entry.name for entry in launch.ENTRIES}
    assert declared >= set(SOURCES), f"sources no entry declares: {set(SOURCES) - declared}"
    assert declared <= set(SOURCES), f"entries of no source: {declared - set(SOURCES)}"


def _no_loading_outside_kernels(modules):
    """No `build.load`, no import of `kernels.build` and no `CDLL` in the
    modules that launch kernels: they go through `kernels.launch.Entry`."""
    found = []
    for sub in ("ops", "pipeline", "parallel", "utils"):
        for path in sorted((build.PACKAGE_DIR / sub).rglob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if ((isinstance(node, ast.Attribute) and node.attr in ("load", "CDLL")
                     and isinstance(node.value, ast.Name) and node.value.id in ("build", "ctypes"))
                        or (isinstance(node, ast.Name) and node.id == "CDLL")
                        or (isinstance(node, ast.ImportFrom) and (node.module or "").endswith(
                            ("kernels", "kernels.build"))
                            and {a.name for a in node.names} & {"build", "load"})):
                    found.append(f"{path.relative_to(build.PACKAGE_DIR)}:{node.lineno}")
    assert found == []


def _no_launches_attributes(modules):
    """The one launch counter is `kernels.launch.LAUNCHES`: no function
    carries a `*launches` attribute and no module a `*launches` count."""
    found = [f"{mod.__name__}.{name}.{attr}" for mod in modules
             for name, obj in vars(mod).items() if callable(obj)
             for attr in getattr(obj, "__dict__", {}) if attr.endswith("launches")]
    found += [f"{mod.__name__}.{name}" for mod in modules
              for name, obj in vars(mod).items() if name.endswith("launches")]
    assert found == []


@pytest.fixture(scope="module")
def package_modules():
    """Every module of the package (its entries declared), but the command
    line entry points."""
    return [importlib.import_module(m.name)
            for m in pkgutil.walk_packages(port.__path__, f"{port.__name__}.")
            if not m.name.endswith("__main__")]


@pytest.mark.parametrize("check", [_declared_sources, _no_loading_outside_kernels,
                                   _no_launches_attributes])
def test_kernel_seam(package_modules, check):
    check(package_modules)
