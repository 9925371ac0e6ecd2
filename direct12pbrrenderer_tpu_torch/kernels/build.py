"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` is compiled by `nvcc` into a shared
library with a plain C interface and loaded with `ctypes` (no PyTorch
headers, so a build takes seconds). Builds happen at first use into
`build/kernels/` at the repository root (git-ignored), keyed on a hash of
the source, the local headers it includes and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. The first use
may come from any thread (the viewer renders on its HTTP handler threads):
`load` builds and loads each library once per process under a lock, and a
build writes a temporary file of its own process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# sm_90a keeps wgmma/setmaxnreg available to later kernels. --fmad=false:
# edge scores decide coverage at exact triangle edges, and the JAX package's
# CPU reference does not contract multiply-adds, so neither may the kernels.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str) -> list[Path]:
    """`csrc/<name>.cu` and the local headers it includes, transitively."""
    files, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f in files:
            continue
        files.append(f)
        todo.extend(f.parent / inc.decode() for inc in _LOCAL_INCLUDE.findall(f.read_bytes()))
    return files


def library_path(name: str) -> Path:
    blob = b"".join(f.read_bytes() for f in source_files(name))
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile `csrc/<name>.cu` unless its keyed library exists. Returns
    (library path, compiler output; empty when the build was reused)."""
    lib = library_path(name)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib, proc.stdout + proc.stderr


_LOADED: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load `csrc/<name>.cu`'s library (once per
    process, whichever thread comes first; the others wait for it)."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                lib = _LOADED[name] = ctypes.CDLL(str(build(name)[0]))
    return lib
