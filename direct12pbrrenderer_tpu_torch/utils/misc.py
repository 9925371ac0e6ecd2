"""Small utilities mirroring Utils/Misc.h: multicast Event, RAII TimeScope,
AlignUp, UUIDs. (The RingBuffer's serialization role is `serialization.Reader`.)
The port's copy of the JAX package's `utils/misc.py`, unchanged.
"""

from __future__ import annotations

import time
import uuid


def align_up(value: int, alignment: int) -> int:
    """AlignUp (Misc.h:101-104)."""
    return (value + alignment - 1) // alignment * alignment


def new_uuid() -> str:
    return uuid.uuid4().hex


class Event:
    """Multicast delegate (Event<Args...>, Misc.h:128-172): += / -= handlers,
    call to dispatch. Used for host-side scene bookkeeping (e.g. octree
    re-insertion on transform change, Scene.h:253-266)."""

    def __init__(self):
        self._handlers: list = []

    def __iadd__(self, fn):
        self._handlers.append(fn)
        return self

    def __isub__(self, fn):
        self._handlers.remove(fn)
        return self

    def __call__(self, *args, **kwargs):
        for fn in list(self._handlers):
            fn(*args, **kwargs)

    def __len__(self):
        return len(self._handlers)


class TimeScope:
    """RAII timer logging on exit (TimeScope, Misc.h:109-126)."""

    def __init__(self, label: str, log=None):
        self.label = label
        self._log = log
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self._log is None:
            import logging

            logging.getLogger("mrtpu.time").debug(
                "%s: %.3f ms", self.label, self.elapsed * 1e3
            )
        else:
            self._log(self.label, self.elapsed)
        return False
