"""Float page cache for the deferred-shading taps — counterpart of
`ops/envcache.py`: `FloatAtlasBuilder`, the plan, `sample_env_tiled` for
the unfused deferred pass (the resolve is kernel F, `ops/env_resolve_cuda.py`;
the fused pass resolves inside kernel D, `ops/shade_fused.py`), and the tap
census that sizes `env_budget` (`tap_census`, `recommend_budget`).

Both deferred passes plan through `env_plan`, from their per-pixel fields to
the staged pages: on a CUDA device the hand-written kernels of
`csrc/env_plan.cu` around kernel B's cover, on the CPU its plain version
`env_plan_reference` (`shading.env_tap_groups`, then `plan_env_tiled`).

The float sibling of the texture cache: the prefiltered env cube's mips, the
skybox faces and the BRDF LUT are stored page-major as clamp-addressed 2x2
quads of 4 channels, rounded to bf16 and packed in pairs into int32 (v[2k]
in the low half, v[2k+1] in the high half). Per screen tile the plan covers
each tap group's pages (kernel B with block_cap 8), keeps one-page coarse
fallback mips per group always staged, and stages the tile's pages in one
gather. The host-side builder is numpy with torch's bf16 rounding (round to
nearest even, as jnp's), so both packages store the same pages.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import PREFILTER_ENVMAP_MIP_LEVELS
from ..kernels.launch import Entry
from ..utils import trace
from . import cover_cuda, env_resolve_cuda
from .cover_two import SENTINEL
from .env_resolve_cuda import REC_I32
from .texcache import (
    MAX_MIPS,
    SEG_CHUNK,
    _compact_layout,
    _cover_and_match,
    _distinct_counts,
    _pack_ids,
    _tile,
    _untile,
    onehot_lookup,
    select_mip,
)

PAGE_W = 16
PAGE_H = 8
PAGE_RECORDS = PAGE_W * PAGE_H
REC_F32 = 16  # 4 clamp-quad corners x 4 channels
CAP_FB = 8    # fallback-page slots per group (a SEG_CHUNK-aligned static list)
MAX_GROUPS = 5   # the deferred pass's tap groups: 4, or 5 with env content
# csrc/env_plan.cu's two kernels, each counted as a launch of env_plan; both
# take the fields' arguments first
_FIELDS = "pppppsiiiipin"
_TAPS = Entry("env_plan", "env_plan_taps_launch", _FIELDS + "pp")
_SELECT = Entry("env_plan", "env_plan_select_launch", _FIELDS + "pppippi" + "p" * 8)


class FloatAtlas(NamedTuple):
    data: torch.Tensor       # (P*128, 8) int32 page-major packed bf16 quad records
    page_base: torch.Tensor  # (T, MAX_MIPS) int32 (clamped to the last mip)
    base_size: torch.Tensor  # (T, 2) int32 (w, h)
    n_mips: torch.Tensor     # (T,) int32
    fb_page: torch.Tensor    # (T,) int32: the one-page coarse fallback mip
    fb_size: torch.Tensor    # (T, 2) int32: that mip's (w, h), <= (16, 8)

    @classmethod
    def from_numpy(cls, *arrays, device) -> "FloatAtlas":
        return cls(*(torch.as_tensor(np.array(a), device=device) for a in arrays))


def _quad_clamp(m: np.ndarray) -> np.ndarray:
    """(h, w, c<=4) -> (h, w, 16) f32 clamp-quad records [c00 c01 c10 c11],
    channels padded to 4 (common.make_quad_tex2d's corner layout)."""
    h, w, c = m.shape
    if c < 4:
        m = np.concatenate([m, np.zeros((h, w, 4 - c), m.dtype)], -1)
    xr = np.minimum(np.arange(w) + 1, w - 1)
    yd = np.minimum(np.arange(h) + 1, h - 1)
    right = m[:, xr]
    down = m[yd]
    diag = right[yd]
    return np.concatenate([m, right, down, diag], -1).astype(np.float32)


def coarse_fallback_mip(last_mip: np.ndarray) -> np.ndarray:
    """Box-downsample an (h, w, c) image until it fits one 16x8 page."""
    m = np.asarray(last_mip, np.float32)
    while m.shape[0] > PAGE_H or m.shape[1] > PAGE_W:
        h2 = max(m.shape[0] // 2, 1)
        w2 = max(m.shape[1] // 2, 1)
        m = m[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, m.shape[-1]).mean((1, 3))
    return m


def _page_major(rec: np.ndarray) -> np.ndarray:
    """(h, w, 16) records -> (pages*128, 16) page-major (16x8-texel pages)."""
    h, w = rec.shape[:2]
    ph = (h + PAGE_H - 1) // PAGE_H * PAGE_H
    pw = (w + PAGE_W - 1) // PAGE_W * PAGE_W
    if (ph, pw) != (h, w):
        padded = np.zeros((ph, pw, REC_F32), rec.dtype)
        padded[:h, :w] = rec
        rec = padded
    return (rec.reshape(ph // PAGE_H, PAGE_H, pw // PAGE_W, PAGE_W, REC_F32)
            .transpose(0, 2, 1, 3, 4).reshape(-1, REC_F32))


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> the uint16 bits of the nearest bf16 value."""
    bf = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    return bf.view(torch.int16).numpy().view(np.uint16)


def quantize_bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 to the nearest bf16 value (returned as f32): the page
    store's precision."""
    return (_bf16_bits(x).astype(np.uint32) << 16).view(np.float32)


def pack_bf16(rec: np.ndarray) -> np.ndarray:
    """(N, REC_F32) f32 -> (N, REC_I32) int32: each value rounded to bf16,
    adjacent pairs packed (v[2k] in the low u16, v[2k+1] in the high u16)."""
    u16 = _bf16_bits(rec).reshape(rec.shape[0], REC_F32)
    lo = u16[:, 0::2].astype(np.uint32)
    hi = u16[:, 1::2].astype(np.uint32)
    return (lo | (hi << 16)).view(np.int32)


class FloatAtlasBuilder:
    """Host-side builder; textures are full mip chains of (h, w, c<=4)."""

    def __init__(self):
        self.chunks: list[np.ndarray] = []
        self.page_base: list[list[int]] = []
        self.sizes: list[tuple[int, int]] = []
        self.mips: list[int] = []
        self.fb: list[int] = []
        self.fb_size: list[tuple[int, int]] = []
        self.cursor = 0

    def _add_pages(self, rec: np.ndarray) -> int:
        start = self.cursor
        paged = _page_major(rec)
        self.chunks.append(paged)
        self.cursor += paged.shape[0] // PAGE_RECORDS
        return start

    def _add_one(self, mips: list[np.ndarray]) -> int:
        offs = [self._add_pages(_quad_clamp(np.asarray(m, np.float32))) for m in mips]
        # fallback: the coarsest mip box-downsampled into ONE 16x8 page, so an
        # overflow tap still resolves directionally at its own uv
        m = coarse_fallback_mip(mips[-1])
        fb = self._add_pages(_quad_clamp(m))
        tid = len(self.sizes)
        self.page_base.append(offs)
        self.sizes.append((mips[0].shape[1], mips[0].shape[0]))
        self.mips.append(len(mips))
        self.fb.append(fb)
        self.fb_size.append((m.shape[1], m.shape[0]))
        return tid

    def add(self, mips: list[np.ndarray]) -> int:
        """One texture (e.g. the BRDF LUT)."""
        return self._add_one(mips)

    def add_cube(self, face_chains: list[list[np.ndarray]]) -> int:
        """6 face mip chains -> 6 consecutive texture ids (returns the first),
        each with its own coarse fallback page."""
        base = None
        for ch in face_chains:
            tid = self._add_one(ch)
            base = tid if base is None else base
        return base

    def build(self, device) -> FloatAtlas:
        n = len(self.sizes)
        pb = np.zeros((n, MAX_MIPS), np.int32)
        for i, offs in enumerate(self.page_base):
            for m in range(MAX_MIPS):
                pb[i, m] = offs[min(m, len(offs) - 1)]
        return FloatAtlas.from_numpy(
            pack_bf16(np.concatenate(self.chunks, 0)), pb,
            np.asarray(self.sizes, np.int32), np.asarray(self.mips, np.int32),
            np.asarray(self.fb, np.int32), np.asarray(self.fb_size, np.int32), device=device)


# ----------------------------------------------------------------- plan ----
def fused_table(atlas: FloatAtlas) -> torch.Tensor:
    """(T, 5+MAX_MIPS) f32 per-texture rows [base_w, base_h, fb_page, fb_w,
    fb_h, page_base[0..MAX_MIPS-1]]."""
    return torch.cat([atlas.base_size, atlas.fb_page[:, None], atlas.fb_size,
                      atlas.page_base[:, :MAX_MIPS]], -1).float()


def _tap_addresses_clamp(base_w, base_h, page_base, mip, u, v):
    """Clamp-addressed page/record/frac for one tap (common._cube_atlas_bilinear
    / sample_quad_tex2d addressing: x0 = clip(floor(x), 0, w-1), fx =
    clip(x - x0, 0, 1))."""
    w = torch.clamp(base_w >> mip, min=1)
    h = torch.clamp(base_h >> mip, min=1)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.minimum(torch.clamp(torch.floor(x), min=0.0), (w - 1).float())
    y0 = torch.minimum(torch.clamp(torch.floor(y), min=0.0), (h - 1).float())
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    pages_x = (w + 15) >> 4
    page = page_base + (y0 >> 3) * pages_x + (x0 >> 4)
    intra = (y0 & 7) * 16 + (x0 & 15)
    return page, intra, fx, fy


def _stage_budget(caps: tuple, stage_budget: int | None) -> int:
    """The staged pages a tile: every group's [fallback | cap] span, or
    `stage_budget` where that is smaller."""
    full_budget = sum(c + CAP_FB for c in caps)
    budget = full_budget if stage_budget is None else min(stage_budget, full_budget)
    if budget % SEG_CHUNK or budget < SEG_CHUNK * len(caps):
        raise ValueError(f"env stage budget {budget} must be a multiple of {SEG_CHUNK} "
                         f"and at least {SEG_CHUNK * len(caps)}")
    return budget


@functools.lru_cache(maxsize=None)
def _fb_index(tids: tuple, device: torch.device) -> torch.Tensor:
    """A group's fallback texture ids padded to CAP_FB with its first, as an
    index tensor on `device`, uploaded once and then reused (a frame makes
    no host-to-device copy for it)."""
    return torch.tensor(tids + (tids[0],) * (CAP_FB - len(tids)), device=device)


def plan_env_tiled(atlas: FloatAtlas, tex_t, mip_t, u_t, v_t, act_t, *, fb_tids: tuple,
                   share: tuple, caps: tuple, block_cap: int, stage_budget: int | None):
    """The env cache's per-frame plan on tiled tap stacks (tiles, G, blocks,
    128): addressing, page covers (kernel B), the static fallback pages and
    the compact staged-page block.

    Returns (off_arr (tiles, G), cnts (tiles, G), staged (tiles, B*8, 128)
    int32 (page p value pair k at row p*8+k), rec_t/fx_t/fy_t (tiles, G,
    blocks, 128), covered_t (tiles, G, blocks, 128) bool). Counts the
    frame's active taps and staged pages (`trace.count`: env_taps,
    env_pages_staged)."""
    n_tiles, g = tex_t.shape[:2]
    if len(caps) != g or len(fb_tids) != g:
        raise ValueError(f"{g} groups need {g} caps and fallback lists")
    if not all(0 < len(t) <= CAP_FB for t in fb_tids):
        raise ValueError(f"each group lists 1..{CAP_FB} fallback textures")
    if any((c + CAP_FB) % SEG_CHUNK for c in caps):
        raise ValueError(f"caps {caps} + {CAP_FB} must be multiples of {SEG_CHUNK}")
    dev = tex_t.device

    row = onehot_lookup(fused_table(atlas), tex_t)           # (tiles, G, b, 128, 18)
    base_w = row[..., 0].to(torch.int32)
    base_h = row[..., 1].to(torch.int32)

    # guaranteed fallback: a bilinear tap on the texture's one-page coarse mip
    # at the same uv; each group's possible textures are static, so its
    # fallback pages are a static list and the slot is a few compares
    _, fintra, fb_fx_t, fb_fy_t = _tap_addresses_clamp(
        row[..., 3].to(torch.int32), row[..., 4].to(torch.int32),
        row[..., 2].to(torch.int32), torch.zeros_like(mip_t), u_t, v_t)
    fb_slot = torch.zeros_like(tex_t)
    for i, tids in enumerate(fb_tids):
        for j, tid in enumerate(tids):
            fb_slot[:, i] = torch.where(tex_t[:, i] == tid, j, fb_slot[:, i])
    fb_rec_t = fb_slot * 128 + fintra
    fb_rows = [atlas.fb_page[_fb_index(tids, dev)][None, :].expand(n_tiles, CAP_FB)
               for tids in fb_tids]

    page, intra, fx, fy = _tap_addresses_clamp(
        base_w, base_h, select_mip(row[..., 5:], mip_t), mip_t, u_t, v_t)
    page_list, count, slot, found = _cover_and_match(page, act_t, tuple(caps), block_cap)

    # compact staging: the sequential clamp reserves SEG_CHUNK rows per later
    # group, so the CAP_FB (= SEG_CHUNK) fallback pages always fit
    budget = _stage_budget(caps, stage_budget)
    off_arr, span_arr = _compact_layout(count, CAP_FB, budget)
    count_eff = torch.minimum(count, span_arr - CAP_FB)

    # budget truncation joins the cover condition, before the shared covers
    fit = found & (slot < count_eff[..., None, None])
    covered_t = fit.clone()
    for grp in share:
        if len(grp) > 1:
            both = functools.reduce(torch.logical_and, [fit[:, i] for i in grp])
            for i in grp:
                covered_t[:, i] = both

    rec_t = torch.where(covered_t, (CAP_FB + slot) * 128 + intra, fb_rec_t)
    fx_t = torch.where(covered_t, fx, fb_fx_t)
    fy_t = torch.where(covered_t, fy, fb_fy_t)

    span_max = max(caps) + CAP_FB
    ids_full = torch.stack([
        torch.nn.functional.pad(torch.cat([fb_rows[i], page_list[:, i, :caps[i]]], -1),
                                (0, span_max - caps[i] - CAP_FB))
        for i in range(g)], 1)
    ids = _pack_ids(off_arr, span_arr, ids_full, budget)
    cnts = CAP_FB + count_eff
    trace.count("env_taps", act_t)
    trace.count("env_pages_staged", cnts)

    n_pages = atlas.data.shape[0] // PAGE_RECORDS
    pages_cm = atlas.data.reshape(n_pages, PAGE_RECORDS, REC_I32).transpose(1, 2)
    staged = pages_cm[ids.reshape(-1).long()].reshape(n_tiles, budget * REC_I32, PAGE_RECORDS)
    return off_arr, cnts, staged, rec_t, fx_t, fy_t, covered_t


# ----------------------------------------------- the deferred pass's plan ----
def env_groups(env_ids: tuple):
    """The static part of the deferred pass's env tap groups from its env_ids
    (env_base, sky_base, lut_tid, env_mips[, has_env]): (env_base, sky_base,
    lut_tid, env_mips, has_env, fb_tids, caps). The groups are the env
    trilinear halves, the BRDF LUT, the background sky and, with env content,
    the mip+3 cascade (`shading.env_tap_groups` builds their taps)."""
    env_base, sky_base, lut_tid, env_mips, has_env = (
        env_ids if len(env_ids) == 5 else (*env_ids, True))
    env_tids = tuple(range(env_base, env_base + 6))
    fb_tids = (env_tids, env_tids, (lut_tid,), tuple(range(sky_base, sky_base + 6)))
    caps = (32, 32, 32, 32)
    if has_env:
        fb_tids += (env_tids,)
        caps += (16,)
    return env_base, sky_base, lut_tid, env_mips, has_env, fb_tids, caps


def env_mip_level(roughness, env_mips: int):
    """The env taps' trilinear level roughness * PREFILTER_ENVMAP_MIP_LEVELS,
    clamped to the chain: (its floor (...) int32, its frac (..., 1))."""
    lvl = torch.clamp(roughness * PREFILTER_ENVMAP_MIP_LEVELS, 0.0, env_mips - 1.0)
    lo = torch.floor(lvl).to(torch.int32)
    return lo, (lvl - lo)[..., None]


def _tiling(shape: tuple, tile: tuple | None):
    """(tiles, blocks, tx, w) of per-pixel fields of leading shape `shape`:
    tile blocks (tiles, blocks, 128) with `tile` None, else an (H, W) image cut
    into `tile` = (tile_h, tile_w) tiles; tx and w are the divisors of
    csrc/env_plan.cu's pixel offsets."""
    if tile is None:
        if len(shape) != 3 or shape[2] != 128:
            raise ValueError(f"tile blocks must be (tiles, blocks, 128), got {shape}")
        return shape[0], shape[1], 1, 128
    (height, width), (tile_h, tile_w) = shape, tile
    if (tile_h * tile_w) % 128 or height % tile_h or width % tile_w:
        raise ValueError(f"a {tile_h}x{tile_w} tile of 128-pixel rows must divide the "
                         f"{height}x{width} frame")
    return (height // tile_h) * (width // tile_w), tile_h * tile_w // 128, width // tile_w, tile_w


def _plane(x: torch.Tensor, tile: tuple | None) -> tuple:
    """(a, b, c, e) of csrc/env_plan.cu's Plane: pixel p of tile t lies at
    element (t / tx) * a + (t % tx) * b + (p / w) * c + (p % w) * e of `x`."""
    s = x.stride()
    if tile is None:
        return s[0], 0, s[1], s[2]
    return tile[0] * s[0], tile[1] * s[1], s[0], s[1]


def env_plan(atlas: FloatAtlas, refl, ray, roughness, n_dot_v, mask, env_ids: tuple, *,
             tile: tuple | None = None, stage_budget: int | None = None):
    """The deferred pass's env-cache plan from its per-pixel fields: the tap
    groups of `shading.env_tap_groups` planned by `plan_env_tiled` (block_cap
    8, groups 0 and 1 sharing one covered mask).

    refl/ray (..., 3), roughness/n_dot_v (...) f32 and mask (...) bool lie in
    tile blocks (tiles, blocks, 128) with `tile` None (the fused pass), or in
    an (H, W) image that `tile` = (tile_h, tile_w) cuts into tiles (the
    unfused pass); they are read in place through their strides. Returns
    (off_arr, cnts, staged, rec_t, fx_t, fy_t, covered_t) as `plan_env_tiled`
    does, env_approx (() int32: the active taps left to the fallback), fracm
    (..., 1) (the trilinear frac, in the fields' layout) and has_env. Counts
    the frame's active taps and staged pages (`trace.count`: env_taps,
    env_pages_staged).

    CUDA tensors launch `csrc/env_plan.cu`: its tap kernel, kernel B's cover
    (`cover_cuda.fused_cover`) and its select kernel, two launches of its own
    a call; CPU tensors take `env_plan_reference`, the plain version. There
    is no fallback between the two: a CUDA input launches or raises."""
    tiles, blocks, tx, w = _tiling(tuple(refl.shape[:-1]), tile)
    if refl.device.type == "cpu":
        return env_plan_reference(atlas, refl, ray, roughness, n_dot_v, mask, env_ids,
                                  tile=tile, stage_budget=stage_budget)
    if refl.device.type != "cuda":
        raise ValueError(f"env_plan: unsupported device {refl.device}")
    env_base, sky_base, lut_tid, env_mips, has_env, fb_tids, caps = env_groups(env_ids)
    g, lead, dev = len(caps), tuple(refl.shape[:-1]), refl.device
    fields = {"refl": (refl, lead + (3,), torch.float32), "ray": (ray, lead + (3,), torch.float32),
              "roughness": (roughness, lead, torch.float32),
              "n_dot_v": (n_dot_v, lead, torch.float32), "mask": (mask, lead, torch.bool)}
    for name, (x, shape, dtype) in fields.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"{name} must be {shape} {dtype} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if not 0 < blocks <= 32:
        raise ValueError(f"kernel B takes 1..32 rows of 128 pixels a tile, got {blocks}")
    data = atlas.data
    if data.dtype != torch.int32 or data.shape[1:] != (REC_I32,) or not data.is_contiguous():
        raise ValueError(f"atlas.data must be contiguous (P*128, {REC_I32}) int32, got "
                         f"{tuple(data.shape)} {data.dtype}")
    budget = _stage_budget(caps, stage_budget)
    table = torch.cat([atlas.base_size, atlas.fb_page[:, None], atlas.fb_size,
                       atlas.page_base[:, :MAX_MIPS]], -1).to(torch.int32)
    planes = (ctypes.c_longlong * 22)(*(v for x in (refl, ray, roughness, n_dot_v, mask)
                                        for v in _plane(x, tile)), refl.stride(-1), ray.stride(-1))
    padded = [t + (t[0],) * (CAP_FB - len(t)) for t in fb_tids] + [(0,) * CAP_FB] * (MAX_GROUPS - g)
    groups = (ctypes.c_int * (5 + MAX_GROUPS * (1 + CAP_FB)))(
        g, env_base, sky_base, lut_tid, env_mips,
        *(len(t) for t in fb_tids), *(0,) * (MAX_GROUPS - g), *(j for t in padded for j in t))
    fields_args = (refl.data_ptr(), ray.data_ptr(), roughness.data_ptr(), n_dot_v.data_ptr(),
                   mask.data_ptr(), planes, tx, w, tiles, blocks, table.data_ptr(),
                   table.shape[0], groups)
    plane_shape = (tiles, g, blocks, 128)
    pages = torch.empty(plane_shape, dtype=torch.int32, device=dev)
    act = torch.empty(plane_shape, dtype=torch.bool, device=dev)
    _TAPS(dev, *fields_args, pages.data_ptr(), act.data_ptr())
    page_list, count, slot, found = cover_cuda.fused_cover(pages, act, caps, 8)
    off_arr = torch.empty((tiles, g), dtype=torch.int32, device=dev)
    cnts = torch.empty((tiles, g), dtype=torch.int32, device=dev)
    staged = torch.empty((tiles, budget * REC_I32, PAGE_RECORDS), dtype=torch.int32, device=dev)
    rec_t = torch.empty(plane_shape, dtype=torch.int32, device=dev)
    fx_t = torch.empty(plane_shape, dtype=torch.float32, device=dev)
    fy_t = torch.empty(plane_shape, dtype=torch.float32, device=dev)
    covered_t = torch.empty(plane_shape, dtype=torch.bool, device=dev)
    env_approx = torch.zeros((), dtype=torch.int32, device=dev)
    _SELECT(dev, *fields_args, data.data_ptr(), count.data_ptr(), page_list.data_ptr(),
            page_list.shape[-1], slot.data_ptr(), found.data_ptr(), budget, off_arr.data_ptr(),
            cnts.data_ptr(), staged.data_ptr(), rec_t.data_ptr(), fx_t.data_ptr(),
            fy_t.data_ptr(), covered_t.data_ptr(), env_approx.data_ptr())
    trace.count("env_taps", act)
    trace.count("env_pages_staged", cnts)
    fracm = env_mip_level(roughness, env_mips)[1]
    return off_arr, cnts, staged, rec_t, fx_t, fy_t, covered_t, env_approx, fracm, has_env


def env_plan_reference(atlas: FloatAtlas, refl, ray, roughness, n_dot_v, mask, env_ids: tuple,
                       *, tile: tuple | None = None, stage_budget: int | None = None):
    """Plain version of `env_plan`: `shading.env_tap_groups` on the fields,
    its (..., G) stacks laid out (tiles, G, blocks, 128), then
    `plan_env_tiled`; env_approx counts the active taps it left uncovered."""
    from .shading import env_tap_groups   # shading imports this module

    tex, mip, u, v, act, fb_tids, caps, fracm, has_env = env_tap_groups(
        refl, ray, roughness, n_dot_v, mask, env_ids)

    def to_g(x):  # (..., G) -> (tiles, G, blocks, 128)
        return x.permute(0, 3, 1, 2) if tile is None else _tile(x.permute(2, 0, 1), *tile)

    act_t = to_g(act)
    plan = plan_env_tiled(atlas, to_g(tex), to_g(mip), to_g(u), to_g(v), act_t, fb_tids=fb_tids,
                          share=((0, 1),), caps=caps, block_cap=8, stage_budget=stage_budget)
    return (*plan, (act_t & ~plan[6]).sum().to(torch.int32), fracm, has_env)


def resolve_untiled(plan: tuple, height: int, width: int, tile_h: int, tile_w: int):
    """Kernel F (`env_resolve_cuda.env_resolve`) over a plan's (off_arr, cnts,
    staged, rec_t, fx_t, fy_t, covered_t), untiled: (rgba (H, W, G, 4),
    covered (H, W, G))."""
    off_arr, cnts, staged, rec_t, fx_t, fy_t, covered_t = plan
    out = env_resolve_cuda.env_resolve(off_arr, cnts, staged, rec_t, fx_t, fy_t)
    rgba = _untile(out, height, width, tile_h, tile_w).permute(2, 3, 0, 1)
    return rgba, _untile(covered_t, height, width, tile_h, tile_w).permute(1, 2, 0)


# -------------------------------------------------------------- sampling ----
def sample_env_tiled(atlas: FloatAtlas, tex, mip, u, v, active, *, fb_tids: tuple,
                     share: tuple = (), tile_h: int = 24, tile_w: int = 128,
                     cap: int | tuple = 28, block_cap: int = 8,
                     stage_budget: int | None = None):
    """Clamp-quad sampling of G tap groups through per-tile page covers:
    (H, W, G) tap stacks are tiled, planned (`plan_env_tiled`, kernel B),
    resolved (kernel F, `env_resolve_cuda.env_resolve`) and untiled.
    Returns (rgba (H, W, G, 4), covered (H, W, G), approx (H, W, G)).

    `covered` taps are exact; `approx` taps (active, not covered) overflowed
    the page budget and resolved as a bilinear tap on the texture's one-page
    coarse fallback mip. Groups listed together in `share` (trilinear mip
    halves) share one covered mask. The JAX package pads a tile's 128-pixel
    rows to a multiple of 8 with inactive pixels; they change no cover and
    are sliced off, so the port tiles without the pad."""
    height, width, g = u.shape
    if (tile_h * tile_w) % 128 or height % tile_h or width % tile_w:
        raise ValueError(f"a {tile_h}x{tile_w} tile of 128-pixel rows must divide the "
                         f"{height}x{width} frame")
    caps = cap if isinstance(cap, tuple) else (cap,) * g

    def tile_g(x):  # (H, W, G) -> (tiles, G, blocks, 128)
        return _tile(x.permute(2, 0, 1), tile_h, tile_w)

    plan = plan_env_tiled(
        atlas, tile_g(tex), tile_g(mip), tile_g(u), tile_g(v), tile_g(active), fb_tids=fb_tids,
        share=share, caps=caps, block_cap=block_cap, stage_budget=stage_budget)
    rgba, covered = resolve_untiled(plan, height, width, tile_h, tile_w)
    return rgba, covered, active & ~covered


# ---------------------------------------------------------------- census ----
def tap_census(atlas: FloatAtlas, tex, mip, u, v, active, tile_h: int = 24, tile_w: int = 128,
               caps: tuple = (32, 32, 32, 32, 16)):
    """Measure realized distinct-page demand per (tile, group) of the env
    cache's tap stacks (H, W, G) through the addressing `plan_env_tiled`
    uses, and the per-tile total of the compact staging spans at the group
    caps. The sort runs on the tensors' device; the counts take numpy's
    percentiles on the host. The JAX package pads a tile's rows to a
    multiple of 8 with absent pages; this census has no row statistic, so
    the padding changes no count and is left out."""
    g = u.shape[-1]
    row = onehot_lookup(fused_table(atlas), tex)
    base_w = row[..., 0].to(torch.int32)
    base_h = row[..., 1].to(torch.int32)
    page, _, _, _ = _tap_addresses_clamp(base_w, base_h, select_mip(row[..., 5:], mip), mip,
                                         u, v)

    def tile_g(x):
        return _tile(x.permute(2, 0, 1), tile_h, tile_w)

    pg = torch.where(tile_g(active), tile_g(page), SENTINEL)
    tiles_n = pg.shape[0]
    counts = _distinct_counts(pg.reshape(tiles_n * g, -1)).reshape(tiles_n, g)
    # staged spans are bounded by the group caps: sized from capped demand
    capped = np.minimum(counts, np.asarray(caps[:g], np.int64)[None, :])
    span = -(-(CAP_FB + capped) // SEG_CHUNK) * SEG_CHUNK
    totals = span.sum(-1)
    return {
        "group": {
            "max": int(counts.max()),
            "p99": int(np.percentile(counts, 99)),
            "mean": float(counts.mean()),
        },
        "tile_total": {
            "max": int(totals.max()),
            "p99": int(np.percentile(totals, 99)),
            "mean": float(totals.mean()),
        },
    }


def recommend_budget(census_frames, headroom: float = 1.5) -> int:
    """SEG_CHUNK-aligned env `stage_budget`, at least the worst sampled tile
    total x headroom and at least 5 x SEG_CHUNK."""
    worst = max(c["tile_total"]["max"] for c in census_frames)
    b = -(-int(worst * headroom) // SEG_CHUNK) * SEG_CHUNK
    return max(b, 5 * SEG_CHUNK)
