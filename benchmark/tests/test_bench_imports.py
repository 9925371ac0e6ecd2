"""No module of the benchmark imports JAX, jaxlib, flax or the JAX package
(compared by whole top-level name: the port's name begins with the JAX
package's and is allowed), and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "direct12pbrrenderer_tpu"}
PORT = "direct12pbrrenderer_tpu_torch"


def imported(path: Path) -> set[str]:
    """Top-level names of every module `path` imports, absolute or
    resolved from a relative import inside the benchmark."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("benchmark" if node.level else (node.module or "").split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported(path)
    assert PORT not in names and not names & FORBIDDEN
    # relative imports stay inside the reference package
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, f"{path.name} reaches out of reference/"


def test_the_walk_sees_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom direct12pbrrenderer_tpu.ops import x\n"
                 "import direct12pbrrenderer_tpu_torch\n")
    assert imported(f) == {"jax", "direct12pbrrenderer_tpu", PORT}


def test_runtime_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "direct12pbrrenderer_tpu_torch_fake", types.ModuleType("x"))
    assert "direct12pbrrenderer_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert "jaxlib.fake" in run.forbidden_modules()
