"""Launch and count the port's hand-written kernels: the one seam between
the wrappers under `ops/` (and the tracer's marks) and `csrc/`.

Each C entry point is declared once, in the wrapper module that calls it,
as an `Entry`: the kernel's name (its `csrc/<name>.cu`, which keys its
library in `build.py`), the C symbol and its argument types. Calling the
entry does the rest of the launch: it loads the library once (`build.load`)
and sets the argument types once, launches on the device's current stream,
raises on a CUDA error, and counts the launch in `LAUNCHES`.

`LAUNCHES` is the process's one launch counter, kernel name -> launches. A
captured frame's replay runs no wrapper, so `pipeline/deferred.capture`
records what a capture added to it and each replay adds that again. A new
kernel is its source and one `Entry` in its wrapper: nothing in `pipeline/`
names it.
"""

from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass, field

import torch

from . import build

# kernel name -> its launches in this process. The keys are the kernels'
# names; an instance of a kernel (kernel B's launch at a cap above 128,
# kernel D's light_dtype loops) also counts under a name of its own.
LAUNCHES: collections.Counter = collections.Counter()
ENTRIES: list[Entry] = []   # every declared entry, in the order of declaration

# argument codes: pointer, int, float, int64 array (strides), pointer array,
# int array; any other argument type is given as its ctypes type
_CODES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
          "s": ctypes.POINTER(ctypes.c_longlong), "P": ctypes.POINTER(ctypes.c_void_p),
          "n": ctypes.POINTER(ctypes.c_int)}


@dataclass
class Entry:
    """C entry point `symbol` of kernel `name`'s library. It takes
    `argtypes` (a code of `_CODES` or a ctypes type each) and then the CUDA
    stream, and returns a CUDA error code. `counted`: whether a launch
    counts in LAUNCHES[name] (the tracer's marks do not)."""
    name: str
    symbol: str
    argtypes: tuple
    counted: bool = True
    _fn: object = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.argtypes = tuple(_CODES.get(t, t) for t in self.argtypes)
        ENTRIES.append(self)

    def __call__(self, device, *args, also: tuple = ()) -> None:
        """Launch on `device`'s current stream; count it under the kernel's
        name and each name in `also`."""
        fn = self._fn
        if fn is None:
            fn = getattr(build.load(self.name), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed ({self.symbol}): "
                               f"CUDA error {err}")
        if self.counted:
            LAUNCHES[self.name] += 1
        for name in also:
            LAUNCHES[name] += 1
