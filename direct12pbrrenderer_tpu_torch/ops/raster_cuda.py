"""Tile rasterizer kernels — counterparts of `ops/raster_pallas.py`:
`rasterize_interp_pallas` (kernel A, fused raster + attribute
interpolation) and `rasterize_pallas` (kernel H, depth only).

`rasterize_interp` launches the hand-written CUDA kernel
`csrc/raster_interp.cu` and `rasterize_depth` the kernel
`csrc/raster_depth.cu` for CUDA tensors; for CPU tensors each runs its plain
PyTorch version (`rasterize_interp_reference`, `rasterize_depth_reference`).
There is no fallback between the two: a CUDA input either launches the kernel
or raises. Both kernels share one depth fold (`csrc/raster_fold.cuh`).

Two-pass semantics of the TPU kernel: every tile renders the first
`min(count, cap_small)` entries of its bin list, and the `hot_k` tiles with
the largest counts render `min(count, cap)`. Here that is one limit per tile
and one launch (`tile_limits`, which the kernels compute from the bin counts
themselves); ties go to the lower tile index exactly like `lax.top_k`.
"""

from __future__ import annotations

import ctypes

import torch

from . import gbuffer, raster

CHUNK = 128  # candidates per staged chunk (the TPU kernel's lane width)
SLICE = 4 * CHUNK  # list entries one kernel block folds at most (raster_fold::kSlice)


def split_caps(cap: int, num_tiles: int) -> tuple[int, int]:
    """(cap_small, hot_k) for the two-pass raster: every tile renders its
    first cap_small list entries; the hot_k fullest tiles render full cap.
    Tiles beyond hot_k whose count exceeds cap_small are overflow (surfaced
    through the pipeline's bin_overflow stat)."""
    if cap <= 2 * CHUNK:
        return cap, 0
    cap_small = max(CHUNK, (cap // 4) // CHUNK * CHUNK)
    hot_k = min(num_tiles, max(64, num_tiles // 6))
    return cap_small, hot_k


def pack_raster_rows(setup: raster.TriangleSetup) -> torch.Tensor:
    """(T, 16) rows [ea0,eb0,ec0, ea1,eb1,ec1, ea2,eb2,ec2, z0,z1,z2, w0,w1,w2, id];
    invalid triangles get ec0 = -3e38 (never inside)."""
    t = setup.edges.shape[0]
    e = setup.edges.reshape(t, 9)
    ec0 = torch.where(setup.valid, e[:, 2], -3e38)
    tri_id = torch.arange(t, dtype=torch.float32, device=e.device)[:, None]
    return torch.cat([e[:, 0:2], ec0[:, None], e[:, 3:9], setup.z, setup.w_clip, tri_id], 1)


def raster_extents(setup: raster.TriangleSetup, viewport=None) -> torch.Tensor:
    """(T, 4) [xmin, ymin, xmax, ymax]: the conservative integer screen AABB
    (binning's) that the kernels' band and per-warp rejects test; -3e38 for
    an invalid triangle, whose xmax then exceeds no pixel edge, so it meets
    no rectangle.

    `setup_triangles` clamps the AABB to the viewport it was given, but a
    canvas padded up to the tile grid (the App's 1440x960 on 1536x960) goes
    on past the viewport's right and bottom edges, where the plain fold
    still covers pixels. So with `viewport` (width, height) given, a max at
    or past its edge is opened to 3e38."""
    aabb = setup.aabb
    if viewport is not None:
        x1, y1 = aabb[:, 2], aabb[:, 3]
        aabb = torch.stack([aabb[:, 0], aabb[:, 1], torch.where(x1 >= viewport[0], 3e38, x1),
                            torch.where(y1 >= viewport[1], 3e38, y1)], 1)
    return torch.where(setup.valid[:, None], aabb, -3e38)


def pack_rows64(setup: raster.TriangleSetup, payload: torch.Tensor,
                viewport=None) -> torch.Tensor:
    """Kernel A's (T, 64) per-triangle row: [raster row 16 | payload 40
    (material 16, vertex attr rows 24) | AABB 4 (`raster_extents`) | pad 4]."""
    pad = torch.zeros((setup.edges.shape[0], 4), dtype=torch.float32, device=payload.device)
    return torch.cat([pack_raster_rows(setup), payload, raster_extents(setup, viewport), pad],
                     1)


def pack_depth_rows(setup: raster.TriangleSetup, viewport=None) -> torch.Tensor:
    """Kernel H's (T, 20) per-triangle row, in two launches: [edges 9, z 3,
    w 3 (`pack_raster_rows`' columns 0:15) | a copy of w2, not read | AABB 4
    (`raster_extents`)], every column -3e38 for an invalid triangle (its AABB
    meets nothing, so its row is never read)."""
    t = setup.edges.shape[0]
    row = torch.cat([setup.edges.reshape(t, 9), setup.z, setup.w_clip, setup.w_clip[:, 2:],
                     raster_extents(setup, viewport)], 1)
    return torch.where(setup.valid[:, None], row, -3e38)


def resolve_caps(cap: int, num_tiles: int, cap_small: int | None, hot_k: int | None):
    auto_small, auto_hot = split_caps(cap, num_tiles)
    cap_small = auto_small if cap_small is None else min(cap_small, cap)
    hot_k = auto_hot if hot_k is None else min(hot_k, num_tiles)
    if cap <= cap_small:
        hot_k = 0
    return cap_small, hot_k


def tile_limits(counts, cap: int, cap_small: int, hot_k: int) -> torch.Tensor:
    """(tiles,) int32 list length each tile renders: min(count, cap_small),
    or min(count, cap) for the hot_k fullest tiles (stable: lower tile index
    wins ties, as lax.top_k)."""
    counts = torch.clamp(counts, max=cap).to(torch.int32)
    limits = torch.clamp(counts, max=cap_small)
    if hot_k > 0:
        hot = torch.sort(counts, descending=True, stable=True).indices[:hot_k]
        limits = limits.index_copy(0, hot, counts[hot])
    return limits.contiguous()


def rasterize_interp(setup: raster.TriangleSetup, bins: raster.Bins, rows64: torch.Tensor,
                     width: int, height: int, tile_h: int, tile_w: int, y_offset=0,
                     cap_small: int | None = None, hot_k: int | None = None,
                     return_tiled: bool = False):
    """-> (tri_id (H, W) int32, z (H, W) f32, planes (24, H, W) f32): planes
    0-7 are the perspective-interpolated [uv, normal_ws, tangent_ws], 8-23
    the winning triangle's material row; zero on background.

    With return_tiled=True, returns (tri_id, z, pl_tiles (tiles, p, 24),
    id_tiles (tiles, p, 1), z_tiles (tiles, p, 1)) in the TPU kernel's tile
    blocks (p = tile_h * tile_w, row-major within the tile; z_tiles is inf
    on background, as the TPU kernel leaves it), which the fused G-buffer
    and deferred passes read."""
    if rows64.device.type == "cpu":
        out = rasterize_interp_reference(setup, bins, rows64, width, height, tile_h,
                                         tile_w, y_offset, cap_small, hot_k)
    else:
        out = _launch(setup, bins, rows64, width, height, tile_h, tile_w, y_offset,
                      cap_small, hot_k)
    if not return_tiled:
        return out
    tri_id, z, planes = out

    def tiles(x):  # (C, H, W) -> (tiles, p, C)
        c, ty, tx = x.shape[0], height // tile_h, width // tile_w
        x = x.reshape(c, ty, tile_h, tx, tile_w).permute(1, 3, 2, 4, 0)
        return x.reshape(ty * tx, tile_h * tile_w, c)

    z_bg = torch.where(tri_id >= 0, z, float("inf"))
    return tri_id, z, tiles(planes), tiles(tri_id[None]), tiles(z_bg[None])


rasterize_interp.launches = 0  # kernel launches in this process (reset by callers)


def _check_raster_args(rows, width, height, tile_h, tile_w, bins, row_cols):
    """Validate a raster kernel's inputs; -> (num_tiles, cap)."""
    tiles_y, tiles_x = height // tile_h, width // tile_w
    num_tiles = tiles_y * tiles_x
    ids, counts = bins.ids, bins.counts
    cap = ids.shape[1]
    if width % tile_w or height % tile_h:
        raise ValueError(f"canvas {width}x{height} is not a whole number of "
                         f"{tile_h}x{tile_w} tiles")
    if tile_w > 512:
        raise ValueError(f"tile width {tile_w} exceeds the kernel's 512 (one warp per 16 "
                         "columns, at most 32 warps a block)")
    if cap % CHUNK:
        raise ValueError(f"bin cap {cap} must be a multiple of {CHUNK}")
    if tuple(ids.shape) != (num_tiles, cap) or tuple(counts.shape) != (num_tiles,):
        raise ValueError(f"bins {tuple(ids.shape)}/{tuple(counts.shape)} do not match "
                         f"{num_tiles} tiles")
    if rows.dim() != 2 or rows.shape[1] != row_cols:
        raise ValueError(f"rows must be (T, {row_cols}), got {tuple(rows.shape)}")
    if rows.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"rows must be float32 and bin ids int32, got "
                        f"{rows.dtype}/{ids.dtype}")
    for name, t in (("bin ids", ids), ("counts", counts)):
        if t.device != rows.device:
            raise ValueError(f"{name} on {t.device}, rows on {rows.device}")
    return num_tiles, cap


def merge_scratch(width: int, height: int, tile_h: int, num_tiles: int, device):
    """The kernels' scratch for hot lists split across blocks, all -1 (all
    ones): H * W per-pixel merge keys, then the work-queue counter, the
    finished-blocks counter and one finished-slices counter per (tile,
    8-row band). A launch leaves it all ones again."""
    bands = -(-tile_h // 8)
    return torch.full((height * width + 2 + num_tiles * bands,), -1, dtype=torch.int64,
                      device=device)


_SCRATCH: dict = {}  # (device, stream, width, height, tile_h, num_tiles) -> merge_scratch


def _scratch(width: int, height: int, tile_h: int, num_tiles: int, device):
    """The `merge_scratch` of this shape for launches on the device's current
    stream: filled once, then reused, since every launch leaves it all ones."""
    key = (device, torch.cuda.current_stream(device).cuda_stream, width, height, tile_h,
           num_tiles)
    if key not in _SCRATCH:
        _SCRATCH[key] = merge_scratch(width, height, tile_h, num_tiles, device)
    return _SCRATCH[key]


def _check_kernel_tensors(rows, ext, ids, counts, scratch, num_tiles: int, height: int,
                          width: int, tile_h: int):
    """Check the tensors a raster launch hands its kernel: all on the rows'
    device; rows (T, 20 or 64) and the AABBs (T, 4) float32, 16-byte aligned
    with rows of whole float4s (the kernel copies raster rows with cp.async
    and loads each AABB as one float4); bin ids (tiles, cap) and counts
    (tiles,) int32; the `merge_scratch` int64. Rows, ids, counts and scratch
    are contiguous; `ext` is a column slice of the rows (columns 56:60 of
    kernel A's rows64, 16:20 of kernel H's rows)."""
    t = rows.shape[0]
    n_scratch = height * width + 2 + num_tiles * -(-tile_h // 8)
    for name, x, dtype, shape in (("rows", rows, torch.float32, (t, rows.shape[1])),
                                  ("AABBs", ext, torch.float32, (t, 4)),
                                  ("bin ids", ids, torch.int32, (num_tiles, ids.shape[1])),
                                  ("bin counts", counts, torch.int32, (num_tiles,)),
                                  ("scratch", scratch, torch.int64, (n_scratch,))):
        if x.device != rows.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape} on {rows.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if x is not ext and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ext.stride(1) != 1 or ext.stride(0) % 4 or rows.data_ptr() % 16 or ext.data_ptr() % 16:
        raise ValueError("rows and AABBs must start 16-byte aligned, in rows of whole float4s")


def _launch(setup, bins, rows64, width, height, tile_h, tile_w, y_offset, cap_small, hot_k):
    if rows64.device.type != "cuda":
        raise ValueError(f"rasterize_interp: unsupported device {rows64.device}")
    num_tiles, cap = _check_raster_args(rows64, width, height, tile_h, tile_w, bins, 64)
    rows64 = rows64.contiguous()
    ids = bins.ids.contiguous()
    counts = bins.counts.contiguous()
    # the kernel derives tile_limits(counts, cap, cap_small, hot_k) itself
    cap_small, hot_k = resolve_caps(cap, num_tiles, cap_small, hot_k)
    dev = rows64.device
    scratch = _scratch(width, height, tile_h, num_tiles, dev)
    # the AABB rides rows64 columns 56:60 (pack_rows64)
    _check_kernel_tensors(rows64, rows64[:, 56:60], ids, counts, scratch, num_tiles, height,
                          width, tile_h)
    tri_id = torch.empty((height, width), dtype=torch.int32, device=dev)
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    planes = torch.empty((24, height, width), dtype=torch.float32, device=dev)
    lib = _library("raster_interp")
    with torch.cuda.device(dev):
        err = lib.raster_interp_launch(
            rows64.data_ptr(), ids.data_ptr(), cap, counts.data_ptr(), cap_small, hot_k,
            num_tiles, width, height, tile_h, tile_w, float(y_offset), scratch.data_ptr(),
            scratch[height * width:].data_ptr(), tri_id.data_ptr(), z.data_ptr(),
            planes.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"raster_interp kernel launch failed: CUDA error {err}")
        rasterize_interp.launches += 1
    return tri_id, z, planes


def rasterize_depth(setup: raster.TriangleSetup, bins: raster.Bins, width: int, height: int,
                    tile_h: int, tile_w: int, y_offset=0, cap_small: int | None = None,
                    hot_k: int | None = None, viewport=None):
    """Depth-only raster (kernel H): -> (tri_id (H, W) int32 [-1 background],
    z (H, W) f32 [1.0 background]), the outputs of raster.rasterize, with the
    TPU kernel's two-pass list limits (every tile folds its first cap_small
    entries, the hot_k fullest their full list). `viewport`: the (width,
    height) that `setup` was made at, where the canvas is padded past it
    (`raster_extents`)."""
    if setup.edges.device.type == "cpu":
        return rasterize_depth_reference(setup, bins, width, height, tile_h, tile_w,
                                         y_offset, cap_small, hot_k)
    if setup.edges.device.type != "cuda":
        raise ValueError(f"rasterize_depth: unsupported device {setup.edges.device}")
    rows = pack_depth_rows(setup, viewport)
    num_tiles, cap = _check_raster_args(rows, width, height, tile_h, tile_w, bins, 20)
    cap_small, hot_k = resolve_caps(cap, num_tiles, cap_small, hot_k)
    ids, counts = bins.ids.contiguous(), bins.counts.contiguous()
    dev = rows.device
    scratch = _scratch(width, height, tile_h, num_tiles, dev)
    # the AABB rides columns 16:20 (pack_depth_rows)
    _check_kernel_tensors(rows, rows[:, 16:20], ids, counts, scratch, num_tiles, height, width,
                          tile_h)
    tri_id = torch.empty((height, width), dtype=torch.int32, device=dev)
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    lib = _library("raster_depth")
    with torch.cuda.device(dev):
        err = lib.raster_depth_launch(
            rows.data_ptr(), ids.data_ptr(), cap, counts.data_ptr(), cap_small, hot_k,
            num_tiles, width, tile_h, tile_w, float(y_offset), scratch.data_ptr(),
            scratch[height * width:].data_ptr(), tri_id.data_ptr(), z.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"raster_depth kernel launch failed: CUDA error {err}")
        rasterize_depth.launches += 1
    return tri_id, z


rasterize_depth.launches = 0  # kernel launches in this process (reset by callers)

_ARGTYPES = {  # the launch functions' C arguments: pointer, int, float
    "raster_interp": "ppipiiiiiiifpppppp",
    "raster_depth": "ppipiiiiiifppppp",
}


def _library(name: str) -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
        fn.argtypes = [kinds[k] for k in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return lib


def rasterize_depth_reference(setup: raster.TriangleSetup, bins: raster.Bins, width: int,
                              height: int, tile_h: int, tile_w: int, y_offset=0,
                              cap_small: int | None = None, hot_k: int | None = None,
                              viewport=None):
    """Plain PyTorch version of kernel H: the plain chunked rasterizer on the
    bin lists cut to the two-pass limits (padding past each tile's limit).
    It has no AABB rejects, so `viewport` changes nothing."""
    num_tiles = (height // tile_h) * (width // tile_w)
    cap = bins.ids.shape[1]
    cap_small, hot_k = resolve_caps(cap, num_tiles, cap_small, hot_k)
    limits = tile_limits(bins.counts, cap, cap_small, hot_k)
    pos = torch.arange(cap, device=bins.ids.device)[None, :]
    cut = raster.Bins(torch.where(pos < limits[:, None], bins.ids, -1), limits)
    return raster.rasterize(setup, cut, width, height, tile_h, tile_w, y_offset=y_offset,
                            longest=int(limits.max()) if num_tiles else 0)


def rasterize_interp_reference(setup: raster.TriangleSetup, bins: raster.Bins,
                               rows64: torch.Tensor, width: int, height: int, tile_h: int,
                               tile_w: int, y_offset=0, cap_small: int | None = None,
                               hot_k: int | None = None):
    """Plain PyTorch version of the kernel: the same per-tile list limits,
    then the plain chunked rasterizer, the rows64[tri_id] gather and the
    `_bary` interpolation of the gather path."""
    tri_id, z = rasterize_depth_reference(setup, bins, width, height, tile_h, tile_w,
                                          y_offset, cap_small, hot_k)
    interp, matrow, mask = gbuffer.interp_from_rows(tri_id, rows64, width, height, y_offset)
    planes = torch.where(mask[..., None], torch.cat([interp, matrow], -1), 0.0)
    return tri_id, z, planes.permute(2, 0, 1).contiguous()
