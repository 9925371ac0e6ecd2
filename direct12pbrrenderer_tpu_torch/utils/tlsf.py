"""TLSF offset allocator — Python wrapper over the native implementation
(native/tlsf.cpp; reference Utils/Allocator.h:626-1102).

Manages offsets into an externally-owned arena (the reference uses it for
64MB GPU heap pages; here it disciplines host staging arenas for asset
uploads).

The port's copy of the JAX package's `utils/tlsf.py`. One difference: the
port's native library is built or its load raises, so the pure-Python
free-list fallback for a missing library is left out.
"""

from __future__ import annotations

from ..native import load


class TlsfAllocator:
    def __init__(self, size: int, min_block: int = 256):
        self._lib = load()
        self.size = size
        self.min_block = min_block
        self._h = self._lib.tlsf_create(size, min_block)

    def alloc(self, size: int, align: int = 1) -> int | None:
        """Returns an offset, or None when the arena can't satisfy it."""
        off = self._lib.tlsf_alloc(self._h, max(size, 1), align)
        return None if off < 0 else int(off)

    def free(self, offset: int) -> bool:
        return bool(self._lib.tlsf_free(self._h, offset))

    @property
    def used(self) -> int:
        return int(self._lib.tlsf_used(self._h))

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.tlsf_destroy(self._h)
            self._h = None
