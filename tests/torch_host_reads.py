"""A guard against host reads in a frame, for the CPU tests of the port's
captured frames (`tests/test_torch_frame_graph.py`) and the band frame's
ranks (`tests/torch_band_ranks.py`). It imports torch and the port only, so
a spawned rank imports it without JAX.

`no_host_reads()` fails on any host read of a tensor (`Tensor.item`,
`tolist`, `__bool__`, `__int__`, `__float__`, `__index__`, `cpu`, `numpy`,
and the aten ops they and boolean indexing dispatch) and on any tensor made
from host data (`torch.tensor`) while its block runs, outside the kernels'
plain versions (which keep their host loop bounds: the card runs the
kernels instead). On a card these are the syncs and pageable copies a CUDA
graph capture refuses.
"""

import contextlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from direct12pbrrenderer_tpu_torch.ops import (atlas_resolve_cuda, cover_cuda, env_resolve_cuda,
                                              lights_cuda, raster_cuda, resolve_shade_cuda,
                                              shade_fused)

# the kernels' plain versions: the CPU's stand-ins for kernels A-G, whose
# loop bounds (and kernel B's cap row) are host values
PLAIN_VERSIONS = {f.__code__ for f in (
    raster_cuda.rasterize_interp_reference, raster_cuda.rasterize_depth_reference,
    cover_cuda.fused_cover_reference, resolve_shade_cuda.resolve_shade_reference,
    shade_fused.deferred_kernel_reference, atlas_resolve_cuda.atlas_resolve_reference,
    env_resolve_cuda.env_resolve_reference, lights_cuda.point_lights_kernel_reference)}
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "cpu",
              "numpy")
# aten ops that read a tensor on the host (a sync on a card: for bincount,
# histc and repeat_interleave the CUDA kernel reads its output size back) or
# make one from host data (a pageable upload on a card)
HOST_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.unique",
            "aten._unique2", "aten.unique_consecutive", "aten.unique_dim", "aten.bincount",
            "aten.histc", "aten.repeat_interleave", "aten.lift_fresh")


def _in_plain_version() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in PLAIN_VERSIONS:
            return True
        f = f.f_back
    return False


@contextlib.contextmanager
def no_host_reads(found: list | None = None):
    """Raise AssertionError on a host read of a tensor or a tensor made
    from host data while the block runs, outside the kernels' plain
    versions; with `found`, append what it names there instead and go on
    (a rank in a collective frame must not stop half way)."""
    def caught(what: str) -> None:
        if found is None:
            raise AssertionError(f"{what} in the frame")
        found.append(what)

    def guarded(name, orig):
        def fn(self, *args, **kwargs):
            if not _in_plain_version():
                caught(f"Tensor.{name}")
            return orig(self, *args, **kwargs)
        return fn

    class Guard(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = f"aten.{func.overloadpacket.__name__}"
            bool_index = name == "aten.index" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1] or ())
            if (name in HOST_OPS or bool_index) and not _in_plain_version():
                caught(str(func))
            return func(*args, **(kwargs or {}))

    originals = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    for name, orig in originals.items():
        setattr(torch.Tensor, name, guarded(name, orig))
    try:
        with Guard():
            yield
    finally:
        for name, orig in originals.items():
            setattr(torch.Tensor, name, orig)
