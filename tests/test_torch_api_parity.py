"""Name parity of the port with the JAX package, read from the sources with
`ast` (neither package is imported, so neither JAX nor torch loads).

For every module of `direct12pbrrenderer_tpu/`, each public name it binds at
module level (a def, a class or an assignment; its imports are not its own
names) must be bound at module level, by any statement, in the port's
module of the same path, or in the module that the MAPPED table names. A
JAX module with no counterpart fails too. The only names let off are in
EXCLUDED, each with its reason.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "direct12pbrrenderer_tpu"
PORT_PKG = ROOT / "direct12pbrrenderer_tpu_torch"

# JAX module -> the port's modules that hold its names (the TPU kernels'
# modules map to the CUDA wrappers that replace them)
MAPPED = {
    "ops/lights_pallas.py": ("ops/lights_cuda.py",),
    "ops/raster_pallas.py": ("ops/raster_cuda.py",),
    "ops/shade_pallas.py": ("ops/shade_fused.py",),
    "tools/tpu_checklist.py": ("tools/checklist.py",),
}
# names the port keeps under another name: (JAX module, name) -> port name
RENAMED = {
    ("ops/raster_pallas.py", "rasterize_interp_pallas"): "rasterize_interp",
    ("ops/raster_pallas.py", "rasterize_pallas"): "rasterize_depth",
}
EXCLUDED = {
    ("ops/texcache.py", "FUSED_COVER_DYNAMIC"):
        "one of three TPU loop forms of one page cover; kernel B computes that "
        "cover in one form, and tools/checklist.py refuses `dyncover`",
    ("ops/texcache.py", "FUSED_COVER_BATCHED"):
        "one of three TPU loop forms of one page cover; kernel B computes that "
        "cover in one form",
    ("resource/native_codec.py", "available"):
        "the port's native library builds or raises (native/__init__.py): no "
        "probe and no numpy fallback behind it",
}


def module_names(path: pathlib.Path, own_only: bool) -> set[str]:
    """Names bound at module level in `path` (also inside module-level if/try
    blocks); with `own_only`, imports do not count."""
    names: set[str] = set()

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    names.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, (ast.Import, ast.ImportFrom)) and not own_only:
                names.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, ast.If):
                walk(node.body)
                walk(node.orelse)
            elif isinstance(node, ast.Try):
                for part in (node.body, node.orelse, node.finalbody,
                             *(h.body for h in node.handlers)):
                    walk(part)

    walk(ast.parse(path.read_text()).body)
    return names


JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


def test_parity_sees_every_module():
    assert len(JAX_MODULES) > 40
    assert {m for m, _ in EXCLUDED} | set(MAPPED) <= set(JAX_MODULES)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    targets = MAPPED.get(module, (module,))
    missing_modules = [t for t in targets if not (PORT_PKG / t).is_file()]
    assert not missing_modules, f"{module}: no port module {missing_modules}"
    have = set().union(*(module_names(PORT_PKG / t, own_only=False) for t in targets))
    public = {n for n in module_names(JAX_PKG / module, own_only=True)
              if not n.startswith("_")}
    missing = sorted(n for n in public
                     if RENAMED.get((module, n), n) not in have and (module, n) not in EXCLUDED)
    assert not missing, f"{module}: no counterpart in {', '.join(targets)} for {missing}"


def test_exclusions_and_renames_are_live():
    """Each excluded name is still in the JAX module and still absent from the
    port, and each renamed one is present under its new name."""
    for (module, name), reason in EXCLUDED.items():
        assert reason
        assert name in module_names(JAX_PKG / module, own_only=True)
        assert name not in module_names(PORT_PKG / module, own_only=False)
    for (module, name), new in RENAMED.items():
        assert name in module_names(JAX_PKG / module, own_only=True)
        assert new in module_names(PORT_PKG / MAPPED[module][0], own_only=False)
