"""The kernels' build keys (`kernels/build.py`), on the CPU: a library is
keyed on its `.cu` source and every local header that source includes,
transitively, so an edit to a shared header rebuilds exactly the kernels
that use it. No compiler is run."""

import shutil

import pytest

from direct12pbrrenderer_tpu_torch.kernels import build

SOURCES = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
# the kernels launched on a persistent grid (csrc/persistent_grid.cuh):
# A and H through raster_fold.cuh, B directly
PERSISTENT = ("fused_cover", "raster_depth", "raster_interp")
# each shared header and the kernels that include it: the in-place plane
# reads of C and D, the texture tap body of C and E, the env tap body of D
# and F
SHARED = {"tap_planes.cuh": ("deferred_shade", "resolve_shade"),
          "tex_resolve.cuh": ("atlas_resolve", "resolve_shade"),
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
