"""Loose octree — Python wrapper over native/octree.cpp (reference
Utils/LooseOctree.h: 1.5x loose bounds, depth<=8, split past 2 elements).

The device render path uses the vectorized all-boxes frustum test
(mathlib.frustum_cull_aabbs); this tree serves host-side incremental
workloads and reference parity. Requires the native library.

The port's copy of the JAX package's `utils/octree.py`; the port's
`native.load()` raises where the library cannot be built, so the wrapper
has no check of its own for a missing library."""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load


class LooseOctree:
    def __init__(self, bound_min, bound_max, max_results: int = 65536):
        self._lib = load()
        mn = np.asarray(bound_min, np.float32)
        mx = np.asarray(bound_max, np.float32)
        self._h = self._lib.octree_create(
            mn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        self._max_results = max_results

    def add(self, bound_min, bound_max) -> int:
        mn = np.asarray(bound_min, np.float32)
        mx = np.asarray(bound_max, np.float32)
        return int(
            self._lib.octree_add(
                self._h,
                mn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                mx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        )

    def update(self, handle: int, bound_min, bound_max) -> None:
        mn = np.asarray(bound_min, np.float32)
        mx = np.asarray(bound_max, np.float32)
        self._lib.octree_update(
            self._h, handle,
            mn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )

    def remove(self, handle: int) -> None:
        self._lib.octree_remove(self._h, handle)

    def frustum_cull(self, planes: np.ndarray) -> np.ndarray:
        """planes (6,4) -> int32 handles of intersecting elements."""
        p = np.ascontiguousarray(planes, np.float32)
        out = np.empty(self._max_results, np.int32)
        n = self._lib.octree_cull(
            self._h,
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._max_results,
        )
        return out[: min(n, self._max_results)].copy()

    @property
    def node_count(self) -> int:
        return int(self._lib.octree_node_count(self._h))

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.octree_destroy(self._h)
            self._h = None
