"""Texture-cache tap resolve + G-buffer pixel shade — counterpart of
`ops/texcache.py::_resolve_shade_kernel` (kernel C).

`resolve_shade` launches the hand-written CUDA kernel `csrc/resolve_shade.cu`
for CUDA tensors, reading the per-pixel planes in place through their
strides (`tap_planes.plane_strides` says which layouts); for CPU tensors it
runs `resolve_shade_reference`, the plain PyTorch version of the same
function. There is no fallback between
the two: a CUDA input either launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import tap_planes

_KERNEL = "resolve_shade"


def resolve_shade(off, cnts, staged, rec, fx, fy, tl, attrs, flags, sel=None, *,
                  trilinear: bool = True):
    """Resolve the 5 material slots' taps against the staged pages and shade.

    off (tiles, G) int32 group start pages in the staged block; cnts (tiles,
    G[+1]) int32 page counts (with the cascade, column G is the tile's
    any-cascade flag); staged (tiles, B*4, 128) int32; rec/fx/fy (tiles, G,
    blocks, 128); tl (tiles, 5, blocks, 128) trilinear fracs; attrs (tiles,
    17, blocks, 128) f32 raster planes 2..18; flags (tiles, 6, blocks, 128)
    int32 [srgb per slot, coverage]; sel (tiles, 5, blocks, 128) int32
    cascade mask or None. -> (tiles, 9, blocks, 128) f32 [albedo(3),
    emission, oct(2), roughness, metallic, ao], RGBA8-quantized, 0 on
    background."""
    if rec.device.type == "cpu":
        return resolve_shade_reference(off, cnts, staged, rec, fx, fy, tl, attrs, flags, sel,
                                       trilinear=trilinear)
    if rec.device.type != "cuda":
        raise ValueError(f"resolve_shade: unsupported device {rec.device}")
    check_taps(off, cnts, staged, rec, fx, fy, tl, sel, trilinear)
    tiles, n_groups, blocks, _ = rec.shape
    cnt_cols = n_groups + (sel is not None)
    for name, x, c, dtype in (("attrs", attrs, 17, torch.float32),
                              ("flags", flags, 6, torch.int32)):
        if tuple(x.shape) != (tiles, c, blocks, 128) or x.dtype != dtype or x.device != rec.device:
            raise ValueError(f"{name} must be {(tiles, c, blocks, 128)} {dtype} on "
                             f"{rec.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    # the per-pixel planes are read in place through their strides (the
    # plan's arrive with the group innermost, attrs is a channel slice of the
    # raster rows): no copy. off, cnts and staged are built contiguous.
    ptrs, strides = tap_planes.plane_args(
        {"rec": rec, "fx": fx, "fy": fy, "tl": tl, "attrs": attrs, "flags": flags, "sel": sel})
    for name, x in (("off", off), ("cnts", cnts), ("staged", staged)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {x.stride()}")
    dev = rec.device
    out = torch.empty((tiles, 9, blocks, 128), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.resolve_shade_launch(
            off.data_ptr(), cnts.data_ptr(), cnt_cols, staged.data_ptr(), staged.shape[1] // 4,
            ptrs, strides, tiles, n_groups, blocks, int(trilinear), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"resolve_shade kernel launch failed: CUDA error {err}")
        resolve_shade.launches += 1
    return out


resolve_shade.launches = 0  # kernel launches in this process (reset by callers)


def check_taps(off, cnts, staged, rec, fx, fy, tl, sel, trilinear: bool):
    """Raise unless the tap-resolve inputs have the layouts kernels C and E
    take (see resolve_shade)."""
    tiles, n_groups, blocks, lanes = rec.shape
    want_groups = 5 * ((2 if trilinear else 1) + (sel is not None))
    if lanes != 128 or n_groups != want_groups:
        raise ValueError(f"rec must be (tiles, {want_groups}, blocks, 128), got "
                         f"{tuple(rec.shape)}")
    shapes = {"off": (off, (tiles, n_groups), torch.int32),
              "cnts": (cnts, (tiles, n_groups + (sel is not None)), torch.int32),
              "fx": (fx, tuple(rec.shape), torch.float32),
              "fy": (fy, tuple(rec.shape), torch.float32),
              "tl": (tl, (tiles, 5, blocks, 128), torch.float32)}
    if sel is not None:
        shapes["sel"] = (sel, (tiles, 5, blocks, 128), torch.int32)
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != rec.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {rec.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if (rec.dtype != torch.int32 or staged.dtype != torch.int32 or staged.dim() != 3
            or staged.shape[0] != tiles or staged.shape[1] % 4 or staged.shape[2] != 128
            or staged.device != rec.device):
        raise ValueError(f"rec must be int32 and staged (tiles, B*4, 128) int32 on "
                         f"{rec.device}, got {rec.dtype} and {tuple(staged.shape)} "
                         f"{staged.dtype} on {staged.device}")


def _library() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_KERNEL)
    fn = lib.resolve_shade_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, ctypes.POINTER(p), ctypes.POINTER(ctypes.c_longlong),
                       i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------- plain version ----
def staged_rows(off, cnts, staged, rec, gi, rows_per_page):
    """The `rows_per_page` staged words of group `gi`'s tap per pixel:
    staged[t, (off + seg) * rows_per_page + k, rec & 127] with seg = rec >>
    7, or 0 where seg is at or beyond ceil8(cnt) (the TPU kernel sweeps
    whole 8-page chunks of the group's span). -> list of (tiles, blocks,
    128) int32. Shared with the env cache's plain resolve."""
    tiles = rec.shape[0]
    budget = staged.shape[1] // rows_per_page
    base = off[:, gi][:, None, None]
    lim = (cnts[:, gi] + 7) // 8 * 8
    r = rec[:, gi]
    seg, lane = r >> 7, (r & 127).long()
    ok = (seg >= 0) & (seg < lim[:, None, None]) & (base + seg < budget)
    row = (torch.clamp(base + seg, 0, budget - 1) * rows_per_page).long()
    t = torch.arange(tiles, device=rec.device)[:, None, None]
    return [torch.where(ok, staged[t, row + k, lane], 0) for k in range(rows_per_page)]


def _resolve_group(off, cnts, staged, rec, fx, fy, gi):
    """Group gi's bilinear tap in storage space: 4 x (tiles, blocks, 128)."""
    quad = staged_rows(off, cnts, staged, rec, gi, 4)
    f_x, f_y = fx[:, gi], fy[:, gi]
    out = []
    for c in range(4):
        tc = [((q >> (8 * c)) & 0xFF).float() * (1.0 / 255.0) for q in quad]
        out.append(tc[0] * (1 - f_x) * (1 - f_y) + tc[1] * f_x * (1 - f_y)
                   + tc[2] * (1 - f_x) * f_y + tc[3] * f_x * f_y)
    return out


def resolve_slot(off, cnts, staged, rec, fx, fy, tl, sel, s, trilinear):
    """Material slot s's tap in storage space (both trilinear halves, or the
    cascade re-tap where sel is set): 4 x (tiles, blocks, 128). The plain tap
    body of kernels C and E (csrc/tex_resolve.cuh)."""
    rgba = _resolve_group(off, cnts, staged, rec, fx, fy, s)
    if trilinear:
        hi = _resolve_group(off, cnts, staged, rec, fx, fy, 5 + s)
        frac = tl[:, s]
        rgba = [lo * (1 - frac) + h * frac for lo, h in zip(rgba, hi)]
    if sel is not None:
        casc = _resolve_group(off, cnts, staged, rec, fx, fy, rec.shape[1] - 5 + s)
        rgba = [torch.where(sel[:, s] != 0, cc, c) for cc, c in zip(casc, rgba)]
    return rgba


def _eotf(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def _norm3(x, y, z):
    inv = 1.0 / torch.clamp(torch.sqrt((x * x + y * y) + z * z), min=1e-20)
    return x * inv, y * inv, z * inv


def resolve_shade_reference(off, cnts, staged, rec, fx, fy, tl, attrs, flags, sel=None, *,
                            trilinear: bool = True):
    """Plain PyTorch version of the kernel: the same channel-form math in
    the same order, over whole (tiles, blocks, 128) planes."""
    samples = []
    for s in range(5):
        rgba = resolve_slot(off, cnts, staged, rec, fx, fy, tl, sel, s, trilinear)
        srgb = flags[:, s] != 0
        samples.append([torch.where(srgb, _eotf(c), c) for c in rgba[:3]] + [rgba[3]])
    mask = flags[:, 5] != 0

    a = attrs
    nx, ny, nz = _norm3(a[:, 0], a[:, 1], a[:, 2])
    tx, ty, tz = _norm3(a[:, 3], a[:, 4], a[:, 5])
    use = [a[:, 12 + i] > 0.5 for i in range(5)]

    # normal mapping: TBN with bitangent = cross(N, T) (gbuffer.hlsl:63-69)
    bx = ny * tz - nz * ty
    by = nz * tx - nx * tz
    bz = nx * ty - ny * tx
    sx, sy, sz = (samples[1][c] * 2.0 - 1.0 for c in range(3))
    mx, my, mz = _norm3(tx * sx + bx * sy + nx * sz, ty * sx + by * sy + ny * sz,
                        tz * sx + bz * sy + nz * sz)
    wx = torch.where(use[1], mx, nx)
    wy = torch.where(use[1], my, ny)
    wz = torch.where(use[1], mz, nz)

    albedo = [torch.pow(torch.clamp(torch.where(use[0], samples[0][c], a[:, 6 + c]), min=0.0),
                        2.2) for c in range(3)]
    roughness = torch.where(use[3], samples[3][0], a[:, 10])
    metallic = torch.where(use[2], samples[2][0], a[:, 11])
    ao = torch.where(use[4], samples[4][0], 0.0)   # AO defaults to 0 (hlsl:135-138)

    ssum = (wx.abs() + wy.abs()) + wz.abs()
    dx, dy, dz = wx / ssum, wy / ssum, wz / ssum
    fx0 = torch.where(dx < 0, -1.0, 1.0) * (1.0 - dy.abs())
    fy0 = torch.where(dy < 0, -1.0, 1.0) * (1.0 - dx.abs())
    ox = torch.where(dz < 0, fx0, dx) * 0.5 + 0.5
    oy = torch.where(dz < 0, fy0, dy) * 0.5 + 0.5

    chans = [*albedo, a[:, 9], ox, oy, roughness, metallic, ao]
    return torch.stack([torch.where(mask, torch.round(torch.clamp(c, 0.0, 1.0) * 255.0)
                                    * (1.0 / 255.0), 0.0) for c in chans], 1)
