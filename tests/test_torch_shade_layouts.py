"""The layouts in which kernels C and D read their per-pixel planes, on the
CPU (no card, no compiler).

Kernels C (`csrc/resolve_shade.cu`) and D (`csrc/deferred_shade.cu`) read
every (tiles, G, blocks, 128) plane in place: `tap_planes.plane_strides`
gives the strides they take, and thread x of a block reads lane x of a row
at p + t st + r sr + g sg + x sx (`csrc/tap_planes.cuh`). Here, on the
inputs that a 256x96 default-path frame gives the two kernels:

* the stride helper describes every recorded plane, and a numpy mirror of
  the kernels' word lookup in the plane's storage gives back every value;
* the helper rejects the layouts the kernels do not take;
* the premises of the kernels' skipped work and of their bounds hold on
  the plain versions: the words that `chip_smoke.resolve_shade_reads` and
  `deferred_reads` leave out (what the bounds of kernels C and D do not
  charge, and a superset of what the kernels skip: a background pixel's
  words in C, the taps of unused slots and those the cascade mask switches
  off; in D the env groups a pixel does not read) can be NaN or any record
  without changing a bit of the output; the cluster slice index is an
  integer, so kernel D's per-block table of powf(far/near, k/8) gives the
  per-pixel powers bit for bit;
* `chip_smoke.dispatched_ops`, the no-copy guard's op record, names an
  output allocation as `OUTPUT_OPS` does, and a copy otherwise.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (OUTPUT_OPS, deferred_reads, dispatched_ops, random_raster_planes,
                        recording, resolve_shade_reads, staged_read_bytes, stub_atlas)
from direct12pbrrenderer_tpu_torch.ops import (resolve_shade_cuda, shade_fused, tap_planes,
                                              texcache)
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from test_torch_pipeline import FUSED_KNOBS, _fused_scene

C_PLANES = {"rec": 3, "fx": 4, "fy": 5, "tl": 6, "attrs": 7, "flags": 8}
D_PLANES = {"rec": 5, "fx": 6, "fy": 7, "gb": 8}


@pytest.fixture(scope="module")
def frame_calls():
    """(args, kwargs) of kernels C and D on a 256x96 default-path frame."""
    scene, cam, cfg = _fused_scene(True)
    pipe = DeferredRenderPipeline(scene, cfg, device="cpu", use_pallas=True,
                                  use_tex_kernel=True, **FUSED_KNOBS)
    with recording(resolve_shade_cuda, "resolve_shade") as c_calls, \
            recording(shade_fused, "deferred_kernel") as d_calls:
        pipe.render(cam)
    (c,), (d,) = c_calls, d_calls
    return {"C": c, "D": d}


def _row_words(x: torch.Tensor, t: int, r: int) -> np.ndarray:
    """Mirror of tap_planes::row and Row: the (G, 128) words of row r of
    tile t of plane x, read from its storage at p + t st + r sr + g sg +
    x sx with the group and lane multipliers as 32-bit ints."""
    st, sg, sr, sx = tap_planes.plane_strides("x", x)
    lg, lx = np.int32(sg), np.int32(sx)
    assert (lg, lx) == (sg, sx)
    n_words = x.untyped_storage().nbytes() // 4
    flat = x.as_strided((n_words,), (1,), 0).view(torch.int32).numpy()
    g, lane = np.meshgrid(np.arange(x.shape[1], dtype=np.int32),
                          np.arange(128, dtype=np.int32), indexing="ij")
    return flat[x.storage_offset() + t * st + r * sr + g * lg + lane * lx]


@pytest.mark.parametrize("kernel,name",
                         [("C", n) for n in C_PLANES] + [("D", n) for n in D_PLANES])
def test_in_place_reads_give_every_recorded_plane(frame_calls, kernel, name):
    args, _ = frame_calls[kernel]
    x = args[(C_PLANES if kernel == "C" else D_PLANES)[name]]
    assert tap_planes.plane_strides(name, x) == x.stride()
    bits = x.contiguous().view(torch.int32).numpy()
    for t in range(x.shape[0]):
        for r in range(x.shape[2]):
            np.testing.assert_array_equal(_row_words(x, t, r), bits[t, :, r, :])


def _base(shape=(2, 5, 3, 128), dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case", ["row_innermost", "expanded_lanes", "overlapping_groups",
                                  "lane_stride_above_32", "float64", "bool", "lanes_not_128"])
def test_stride_helper_rejects_other_layouts(case):
    x = {
        "row_innermost": lambda: torch.zeros(2, 128, 5, 3).permute(0, 2, 3, 1),
        "expanded_lanes": lambda: torch.zeros(2, 5, 3, 1).expand(2, 5, 3, 128),
        "overlapping_groups": lambda: torch.zeros(2 * 3 * 128 * 4 + 4).as_strided(
            (2, 5, 3, 128), (3 * 128 * 4, 1, 128 * 4, 4)),
        "lane_stride_above_32": lambda: torch.zeros(2, 3, 128, 40)[..., :5].permute(0, 3, 1, 2),
        "float64": lambda: _base(dtype=torch.float64),
        "bool": lambda: _base(dtype=torch.bool),
        "lanes_not_128": lambda: _base((2, 5, 3, 64)),
    }[case]()
    with pytest.raises(ValueError):
        tap_planes.plane_strides(case, x)


def test_stride_helper_takes_both_layouts_and_slices():
    rows = torch.zeros(2, 3 * 128, 24)
    attrs = rows.reshape(2, 3, 128, 24).permute(0, 3, 1, 2)[:, 2:19]
    assert tap_planes.plane_strides("attrs", attrs) == (3 * 128 * 24, 1, 128 * 24, 24)
    assert tap_planes.plane_strides("gb", _base()) == (5 * 3 * 128, 3 * 128, 128, 1)
    gb = torch.cat([_base(), _base((2, 2, 3, 128))], 1)
    assert tap_planes.plane_strides("gb", gb) == gb.stride()
    ptrs, strides = tap_planes.plane_args({"a": attrs, "sel": None})
    assert ptrs[1] is None and list(strides) == [*attrs.stride(), 0, 0, 0, 0]


def test_cluster_slice_powers_come_from_a_nine_entry_table(frame_calls):
    args, _ = frame_calls["D"]
    const, gb = args[0], args[8]
    near, far, log_zr, fn_ratio = const[2], const[3], const[19], const[20]
    zc = torch.minimum(torch.maximum(gb[:, 9], near), far)
    szf = torch.clamp(torch.floor(8 * torch.log(zc / near) / log_zr), 0, 7)
    assert torch.equal(szf, szf.round()) and szf.min() >= 0 and szf.max() <= 7
    table = torch.pow(fn_ratio, torch.arange(9, dtype=torch.float32) / 8)
    k = szf.long()
    assert torch.equal(torch.pow(fn_ratio, szf / 8), table[k])
    assert torch.equal(torch.pow(fn_ratio, (szf + 1) / 8), table[k + 1])


def _poison(rng, x, where):
    """x with the words at `where` replaced: NaN for floats, random records
    for ints."""
    if x.dtype == torch.int32:
        other = torch.as_tensor(rng.integers(-(1 << 12), 1 << 12, x.shape), dtype=torch.int32)
    else:
        other = torch.full_like(x, float("nan"))
    return torch.where(where.expand(x.shape), other, x)


def _shade_calls(case):
    if case == "frame":
        return None
    h, w, th, tw = 96, 256, 24, 128
    pl_tiles, id_tiles = random_raster_planes(np.random.default_rng(3), h, w, th, tw)
    knobs = {"bilinear": dict(filter="bilinear"),
             "cascade": dict(filter="trilinear", cascade=True, cap_lo=4, cap_hi=4,
                             block_cap=(4, 4))}[case]
    with recording(resolve_shade_cuda, "resolve_shade") as calls:
        texcache.shade_planes_fused(stub_atlas(np.random.default_rng(1), "cpu"),
                                    torch.as_tensor(pl_tiles), torch.as_tensor(id_tiles), h, w,
                                    th, tw, **knobs)
    (call,) = calls
    return call


@pytest.mark.parametrize("case", ["frame", "bilinear", "cascade"])
def test_resolve_shade_bound_leaves_out_only_words_the_output_ignores(frame_calls, case):
    args, kw = _shade_calls(case) or frame_calls["C"]
    args = list(args) + [None] * (10 - len(args))
    reads = resolve_shade_reads(args, kw)
    taps = reads["rec"]
    # the CPU frame's materials have no maps, so its output reads no tap
    assert (~taps).any() and (case == "frame" or taps.any())
    rng = np.random.default_rng(11)
    poisoned = list(args)
    for i, name in enumerate(("rec", "fx", "fy", "tl", "attrs", "flags", "sel")):
        if args[3 + i] is not None:
            assert tuple(reads[name].shape) == tuple(args[3 + i].shape), name
            poisoned[3 + i] = _poison(rng, args[3 + i], ~reads[name])
    want = resolve_shade_cuda.resolve_shade_reference(*args, **kw)
    got = resolve_shade_cuda.resolve_shade_reference(*poisoned, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    off, cnts, staged, rec = args[:4]
    every = staged_read_bytes(off, cnts, staged, rec, 4)
    assert staged_read_bytes(off, cnts, staged, rec, 4, torch.ones_like(taps)) == every
    assert staged_read_bytes(off, cnts, staged, rec, 4, taps) <= every
    assert staged_read_bytes(off, cnts, staged, rec, 4, torch.zeros_like(taps)) == 0


def test_deferred_bound_leaves_out_only_words_the_output_ignores(frame_calls):
    args, kw = frame_calls["D"]
    reads = deferred_reads(args, kw)
    lit = args[8][:, 10] > 0.5
    per_px = reads["rec"].sum(1)
    assert (per_px[~lit] == 1).all() and (per_px[lit] >= 2).all() and (per_px[lit] <= 3).all()
    rng = np.random.default_rng(13)
    poisoned = list(args)
    for i, name in enumerate(("rec", "fx", "fy", "gb")):
        assert tuple(reads[name].shape) == tuple(args[5 + i].shape), name
        poisoned[5 + i] = _poison(rng, args[5 + i], ~reads[name])
    want = shade_fused.deferred_kernel_reference(*args, **kw)
    got = shade_fused.deferred_kernel_reference(*poisoned, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_dispatch_record_tells_an_output_allocation_from_a_copy():
    x = torch.zeros(2, 3).t()
    assert dispatched_ops(lambda: torch.empty((4, 128), dtype=torch.float32)) == list(OUTPUT_OPS)
    ops = dispatched_ops(lambda: x.contiguous())
    assert ops and any(op not in OUTPUT_OPS for op in ops), ops
