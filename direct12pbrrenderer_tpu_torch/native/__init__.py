"""Native C++ runtime library (BC codecs, TLSF allocator, loose octree),
loaded with ctypes — counterpart of the JAX package's `native/`.

`bcodec.cpp`, `tlsf.cpp` and `octree.cpp` are copies of the JAX package's
sources. Differences from its loader:
* the library builds at first use into `build/native/` at the repository
  root (git-ignored), not into the package directory, with the JAX
  `Makefile`'s flags (`g++ -O2 -fPIC -std=c++17 -Wall -shared`, no `make`),
  keyed on a hash of the sources and the flags, so an edited source is
  rebuilt and an unchanged one reused;
* the build runs under an exclusive `fcntl` lock on `build/native/lock`,
  and the finished library replaces its temporary file atomically, so
  processes that load at once (pytest-xdist workers) build it once;
* a build or load that fails raises; there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "native"
SOURCES = ("bcodec.cpp", "tlsf.cpp", "octree.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")


def library_path() -> Path:
    blob = b"".join((_DIR / s).read_bytes() for s in SOURCES)
    digest = hashlib.sha256(blob + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmrtpu-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless its keyed file exists; returns its path.
    Raises RuntimeError when the compiler fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if lib.exists():                   # another process built it meanwhile
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in SOURCES)],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native library:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load and bind the library (once per process)."""
    lib = ctypes.CDLL(str(build()))
    _configure(lib)
    return lib


def _configure(lib: ctypes.CDLL) -> None:
    from ctypes import (POINTER, c_float, c_int, c_int32, c_int64, c_uint8, c_uint16,
                        c_uint64, c_void_p)

    lib.bc1_decode.argtypes = [POINTER(c_uint8), c_int, c_int, POINTER(c_uint8)]
    lib.bc1_encode.argtypes = [POINTER(c_uint8), c_int, c_int, POINTER(c_uint8)]
    lib.bc6h_decode.argtypes = [POINTER(c_uint8), c_int, c_int, POINTER(c_uint16)]
    lib.bc6h_encode.argtypes = [POINTER(c_uint16), c_int, c_int, POINTER(c_uint8)]
    for fn in ("bc1_decode", "bc1_encode", "bc6h_decode", "bc6h_encode"):
        getattr(lib, fn).restype = None

    lib.tlsf_create.restype = c_void_p
    lib.tlsf_create.argtypes = [c_uint64, c_uint64]
    lib.tlsf_destroy.restype = None
    lib.tlsf_destroy.argtypes = [c_void_p]
    lib.tlsf_alloc.restype = c_int64
    lib.tlsf_alloc.argtypes = [c_void_p, c_uint64, c_uint64]
    lib.tlsf_free.restype = c_int
    lib.tlsf_free.argtypes = [c_void_p, c_uint64]
    lib.tlsf_used.restype = c_uint64
    lib.tlsf_used.argtypes = [c_void_p]
    lib.tlsf_total.restype = c_uint64
    lib.tlsf_total.argtypes = [c_void_p]

    lib.octree_create.restype = c_void_p
    lib.octree_create.argtypes = [POINTER(c_float), POINTER(c_float)]
    lib.octree_destroy.restype = None
    lib.octree_destroy.argtypes = [c_void_p]
    lib.octree_add.restype = c_int32
    lib.octree_add.argtypes = [c_void_p, POINTER(c_float), POINTER(c_float)]
    lib.octree_update.restype = None
    lib.octree_update.argtypes = [c_void_p, c_int32, POINTER(c_float), POINTER(c_float)]
    lib.octree_remove.restype = None
    lib.octree_remove.argtypes = [c_void_p, c_int32]
    lib.octree_cull.restype = c_int
    lib.octree_cull.argtypes = [c_void_p, POINTER(c_float), POINTER(c_int32), c_int]
    lib.octree_node_count.restype = c_int
    lib.octree_node_count.argtypes = [c_void_p]
