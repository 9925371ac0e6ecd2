"""Software texture cache — counterpart of `ops/texcache.py`.

Per 24x128-px screen tile the plan extracts the distinct atlas pages each
(material slot, trilinear half) touches, plus up to CAP_FB guaranteed
coarsest-mip fallback pages per group, and stages all tiles' pages in one
gather. The page covers run on kernel B (`ops/cover_cuda.py`) at every
group cap; above 128 that one launch stands for the TPU's two-kernel cover,
kernel I, whose plain form is `_cover_and_match_2level` over
`ops/cover_two.py`. Two resolves run on the plan: kernel C
(`ops/resolve_shade_cuda.py`, the tap resolve plus the gbuffer.hlsl pixel
shade) for the fused G-buffer (`shade_planes_fused`), and kernel E
(`ops/atlas_resolve_cuda.py`, the storage-space taps) for the planar one
(`sample_atlas_tiled`, `sample_atlas_textured`). Both plan through
`tex_plan`, from their per-pixel fields to the staged pages: on a CUDA
device the hand-written kernels of `csrc/tex_plan.cu` around kernel B's
covers, on the CPU its plain version `tex_plan_reference` (the fused path's
tap setup, then `_plan_and_stage`). The tap census
(`tap_census`, `recommend_caps`, `recommend_block_caps`, `recommend_budget`)
measures a frame's page demand and sizes the cache's knobs for
`tex_caps="auto"`. Layouts at module boundaries are the JAX package's:
per-pixel planes are `(tiles, G, blocks, 128)`, 128 consecutive pixels of a
tile row being one lane row.

Differences from the TPU plan, none of which changes a value:
* `onehot_lookup` is a plain indexed load `table[key]` (the TPU's one-hot
  MXU product existed to avoid per-element gathers; both are exact);
* `blocks` is not padded to a multiple of 8 (a TPU sublane rule): padded
  rows are inactive, so they add no page to any cover and the unpadded
  region is the same (the tap census keeps the pad: its per-row statistic
  counts the padded rows);
* the staged block gathers whole pages from the atlas viewed channel-major,
  one pass instead of a gather and a transpose.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels.launch import Entry
from . import (atlas_resolve_cuda, common, cover_cuda, cover_two, gbuffer,
               resolve_shade_cuda)
from ..utils import trace
from .cover_two import SENTINEL
from .gbuffer import AtlasDevice

MAX_MIPS = 13
CAP_FB = 4       # guaranteed last-mip fallback pages per group
SEG_CHUNK = 8    # staged-span granularity (the TPU kernel's sweep chunk)
# csrc/tex_plan.cu's kernels, each counted as a launch of tex_plan: the taps
# and the select take the fields' and the plan's arguments first
_ARGS = ("i", "P", "s", "n", "p", "i", "n")
_TAPS = Entry("tex_plan", "tex_plan_taps_launch", _ARGS + ("p", "p"))
_CASCADE = Entry("tex_plan", "tex_plan_cascade_launch", ("p", "p", "p", ctypes.c_longlong, "p"))
_SELECT = Entry("tex_plan", "tex_plan_select_launch", _ARGS + ("p", "P", "n", "P"))


# --------------------------------------------------------------- tiling ----
def pick_tile(height: int, width: int, max_pixels: int = 4096):
    """Choose a (tile_h, tile_w) screen tiling for the texture cache: about
    24x128, tile_h*tile_w a multiple of 128 dividing the frame; None when the
    frame admits no such tiling."""
    tws = sorted((d for d in range(32, min(width, 512) + 1) if width % d == 0),
                 key=lambda d: abs(d - 128))
    for tw in tws:
        ths = sorted(
            (d for d in range(4, min(height, 64) + 1)
             if height % d == 0 and (d * tw) % 128 == 0 and d * tw <= max_pixels),
            key=lambda d: abs(d - 3072 // tw),
        )
        if ths:
            return ths[0], tw
    return None


def _tile(img, tile_h, tile_w):
    """(..., H, W) leading-batched image -> (tiles, ..., blocks, 128)."""
    *lead, h, w = img.shape
    ty, tx = h // tile_h, w // tile_w
    n = len(lead)
    x = img.reshape(*lead, ty, tile_h, tx, tile_w)
    x = x.permute(n, n + 2, *range(n), n + 1, n + 3)      # (ty, tx, ..., th, tw)
    return x.reshape(ty * tx, *lead, tile_h * tile_w // 128, 128)


def _untile(tiles, height, width, tile_h, tile_w):
    """(n_tiles, ..., blocks, 128) -> (..., H, W)."""
    ty, tx = height // tile_h, width // tile_w
    lead = tiles.shape[1:-2]
    n = len(lead)
    x = tiles.reshape(ty, tx, *lead, tile_h, tile_w)
    x = x.permute(*range(2, 2 + n), 0, 2 + n, 1, 3 + n)  # (..., ty, th, tx, tw)
    return x.reshape(*lead, height, width)


# ------------------------------------------------------- table lookups ----
def fused_tex_table(atlas: AtlasDevice) -> torch.Tensor:
    """(T, 4+MAX_MIPS) f32 table keyed by tex: [n_mips, base_w, base_h,
    fallback_page, page_base[0..MAX_MIPS-1]], all values int-exact. The
    fallback page is page_base[n_mips] (the 1x1-addressable coarsest mip)."""
    last = atlas.page_base.gather(
        1, torch.clamp(atlas.n_mips, max=MAX_MIPS - 1)[:, None].long())
    return torch.cat([atlas.n_mips[:, None], atlas.base_size, last,
                      atlas.page_base[:, :MAX_MIPS]], -1).float()


def select_mip(pb, mip):
    """pb (..., MAX_MIPS) f32 page bases, mip (...,) int32 -> (...,) int32
    (0 for a mip outside the table, as the TPU's one-hot select)."""
    ok = (mip >= 0) & (mip < pb.shape[-1])
    idx = torch.clamp(mip, 0, pb.shape[-1] - 1).long()[..., None]
    return torch.where(ok, pb.gather(-1, idx)[..., 0], 0.0).to(torch.int32)


def onehot_lookup(table, key):
    """table (n, k) f32, key (...,) int -> (..., k): the row of each key, a
    zero row for a key outside the table (the TPU's one-hot product)."""
    n = table.shape[0]
    ok = (key >= 0) & (key < n)
    rows = table[torch.clamp(key, 0, n - 1).long()]
    return torch.where(ok[..., None], rows, 0.0)


# ----------------------------------------------------------------- plan ----
def _tap_addresses(base_w, base_h, page_base, mip, u, v):
    """Per-pixel page id + intra-page record index + bilinear fracs for one
    wrap-addressed mip tap (gbuffer._sample_mip_bilinear's addressing)."""
    w = torch.clamp(base_w >> mip, min=1)
    h = torch.clamp(base_h >> mip, min=1)
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = torch.remainder(x0f.to(torch.int32), w)
    y0 = torch.remainder(y0f.to(torch.int32), h)
    pages_x = (w + 15) >> 4
    page = page_base + (y0 >> 3) * pages_x + (x0 >> 4)
    intra = (y0 & 7) * 16 + (x0 & 15)
    return page, intra, fx, fy


def _mip_plan(atlas, tex, lod, trilinear):
    """Per-pixel table lookup + mip selection: (base_w, base_h, page-base
    rows, fallback page, [mip_lo(, mip_hi)], trilinear frac, n_mips)."""
    row0 = onehot_lookup(fused_tex_table(atlas), tex)
    n_mips_t = row0[..., 0].to(torch.int32)
    base_w = row0[..., 1].to(torch.int32)
    base_h = row0[..., 2].to(torch.int32)
    fb_page = row0[..., 3].to(torch.int32)
    pb = row0[..., 4:]
    lod = torch.minimum(torch.clamp(lod, min=0.0), (n_mips_t - 1).float())
    if trilinear:
        m_lo = torch.floor(lod).to(torch.int32)
        tfrac = lod - m_lo
        mips = [m_lo, torch.minimum(m_lo + 1, n_mips_t - 1)]
    else:
        m_lo = torch.round(lod).to(torch.int32)
        tfrac = torch.zeros_like(lod)
        mips = [m_lo]
    return base_w, base_h, pb, fb_page, mips, tfrac, n_mips_t


def _cover_and_match(pages, act, cap, block_cap: int):
    """pages/act (tiles, g, blocks, 128): the two-level page cover, one
    launch of kernel B at any cap (above 128 it replaces the TPU's two-kernel
    cover, kernel I). `cap` is one int or a per-group tuple. Returns
    (page_list (tiles, g, cap_max) ascending, 0-padded; count (tiles, g);
    slot; found)."""
    caps = cap if isinstance(cap, tuple) else (cap,) * pages.shape[1]
    return cover_cuda.fused_cover(pages, act, caps, block_cap)


def _distinct_by_sort(cand, cap_max: int, cap_arr=None):
    """Distinct values per row of `cand` (..., L) int32 (SENTINEL = absent)
    by a stable sort (lax.sort is stable). cap_arr (optional) broadcasts
    against the leading dims: per-row caps <= cap_max. Returns (page_list
    (..., cap_max) ascending distinct values, 0-padded; count (...,) clamped
    to the row's cap; slot (..., L) each element's rank among the distinct
    values, clamped to cap - 1; found (..., L) rank < cap, where a SENTINEL
    element's rank is L)."""
    n = cand.shape[-1]
    dev = cand.device
    if cap_arr is None:
        cap_arr = torch.full((1,) * (cand.dim() - 1), cap_max, dtype=torch.int32, device=dev)
    sv, sp = torch.sort(cand, dim=-1, stable=True)
    live = sv != SENTINEL
    first = torch.cat([torch.ones_like(live[..., :1]), sv[..., 1:] != sv[..., :-1]], -1) & live
    rank_sorted = torch.cumsum(first.to(torch.int32), -1, dtype=torch.int32) - 1
    rank_sorted = torch.where(live, rank_sorted, n)
    count = torch.minimum(first.sum(-1, dtype=torch.int32), cap_arr)
    # the distinct values at their ranks (the sort by rank of the JAX glue)
    width = max(n, cap_max) + 1
    buf = torch.zeros((*cand.shape[:-1], width), dtype=torch.int32, device=dev)
    buf.scatter_(-1, torch.where(first, rank_sorted, width - 1).long(), torch.where(first, sv, 0))
    lane = torch.arange(cap_max, device=dev)
    page_list = torch.where(lane < count[..., None], buf[..., :cap_max], 0)
    rank = torch.empty_like(rank_sorted).scatter_(-1, sp, rank_sorted)
    cap_e = cap_arr[..., None]
    return page_list, count, torch.minimum(rank, cap_e - 1), rank < cap_e


def _cover_and_match_2level(pages, act, caps: tuple, block_cap: int):
    """Kernel I's plain version, the JAX package's two-kernel cover step for
    step, for any caps: the row scan (`cover_two.block_cover_reference`), the
    tile-level distinct sort, then each pixel's slot and coverage through its
    row candidate (`cover_two.pix_match_reference`). It gives kernel B's four
    outputs bit for bit at every cap; no path of the port calls it."""
    tiles, g, blocks, _ = pages.shape
    cand, slot_a = cover_two.block_cover_reference(pages, act, block_cap)
    cap_arr = torch.tensor(caps, dtype=torch.int32, device=pages.device)[None, :]
    page_list, count, slot_b, found_b = _distinct_by_sort(
        cand.reshape(tiles, g, blocks * block_cap), max(caps), cap_arr)
    slot, cov = cover_two.pix_match_reference(
        slot_a, slot_b.reshape(cand.shape), found_b.reshape(cand.shape), block_cap)
    return page_list, count, slot, cov & act


def _align8(x):
    return -(-x // SEG_CHUNK) * SEG_CHUNK


def _compact_layout(counts_all, cap_fb, budget):
    """The demand-shaped staging layout: each group's [fallback | cover]
    span at a SEG_CHUNK-aligned offset under the per-tile budget, with
    SEG_CHUNK rows reserved for every later group so its fallback pages
    always fit. counts_all (tiles, G) -> (off (tiles, G), span (tiles, G))."""
    n_tiles, n_groups = counts_all.shape
    span_want = _align8(cap_fb + counts_all)
    offs, spans = [], []
    off = torch.zeros((n_tiles,), dtype=torch.int32, device=counts_all.device)
    for gi in range(n_groups):
        reserve = SEG_CHUNK * (n_groups - 1 - gi)
        s_eff = torch.minimum(span_want[:, gi], budget - off - reserve)
        offs.append(off)
        spans.append(s_eff)
        off = off + s_eff
    return torch.stack(offs, 1), torch.stack(spans, 1)


def _pack_ids(off_arr, span_arr, ids_full, budget):
    """Scatter each group's page ids (tiles, G, span_max) to its compact
    offset -> (tiles, budget); truncated rows land on a dump column."""
    n_tiles, n_groups, span_max = ids_full.shape
    j = torch.arange(span_max, dtype=torch.int32, device=ids_full.device)
    dst = torch.where(j < span_arr[..., None], off_arr[..., None] + j, budget)
    ids = torch.zeros((n_tiles, budget + 1), dtype=torch.int32, device=ids_full.device)
    ids.scatter_(1, dst.reshape(n_tiles, -1).long(), ids_full.reshape(n_tiles, -1))
    return ids[:, :budget]


def _plan_and_stage(atlas, tex_t, u_t, v_t, lod_t, act_t, *, trilinear, cap_lo, cap_hi,
                    block_cap, stage_budget, cascade=False, cap_casc=12,
                    block_cap_casc=4, casc_mip=3):
    """The texture cache's per-frame plan in tiled layout: mip selection,
    tap addressing, page covers (kernel B) and the compact staged-page block.
    Per-pixel inputs are (tiles, 5, blocks, 128).

    Returns (off_arr (tiles, G), cnts (tiles, G[+1]; with cascade the last
    column is the per-tile any-cascade flag), staged (tiles, B*4, 128) int32
    page block (page p channel c at row p*4+c), rec/fx/fy (tiles, G, blocks,
    128), tl (tiles, 5, blocks, 128) trilinear fracs, covered (tiles, 5,
    blocks, 128) bool, sel (tiles, 5, blocks, 128) int32 cascade mask or
    None). Counts the frame's active taps and staged pages (`trace.count`:
    tex_taps, tex_pages_staged)."""
    n_tiles = tex_t.shape[0]
    for c in (cap_lo, cap_hi, cap_casc):
        if (c + CAP_FB) % SEG_CHUNK:
            raise ValueError(f"cap {c} + {CAP_FB} fallback pages must be a multiple "
                             f"of {SEG_CHUNK}")

    base_w, base_h, pb, fb_page0, mips, tfrac_t, n_mips_t = _mip_plan(
        atlas, tex_t, lod_t, trilinear)

    # guaranteed fallback tap: the coarsest mip (1x1, the texture's average)
    fb_fx_t = (u_t - 0.5) - torch.floor(u_t - 0.5)
    fb_fy_t = (v_t - 0.5) - torch.floor(v_t - 0.5)
    fb_list, _, fb_slot_t, _ = _cover_and_match(fb_page0, act_t, CAP_FB, CAP_FB)

    bc_halves = block_cap if isinstance(block_cap, tuple) else (block_cap, block_cap)
    halves = []
    for i, (m, cap) in enumerate(zip(mips, (cap_lo, cap_hi))):
        page, intra, fx, fy = _tap_addresses(base_w, base_h, select_mip(pb, m), m, u_t, v_t)
        page_list, count, slot, found = _cover_and_match(page, act_t, cap, bc_halves[i])
        halves.append((page_list, count, slot, intra, fx, fy, found))

    groups = list(halves)
    caps_list = list((cap_lo, cap_hi)[: len(halves)])
    if cascade:
        foundall = halves[0][6]
        for h in halves[1:]:
            foundall = foundall & h[6]
        mip_c = torch.minimum(mips[0] + casc_mip, n_mips_t - 1)
        page_c, intra_c, fx_c, fy_c = _tap_addresses(
            base_w, base_h, select_mip(pb, mip_c), mip_c, u_t, v_t)
        pl_c, cnt_c, slot_c, found_c = _cover_and_match(
            page_c, act_t & ~foundall, cap_casc, block_cap_casc)
        groups.append((pl_c, cnt_c, slot_c, intra_c, fx_c, fy_c, found_c))
        caps_list.append(cap_casc)

    # compact staging: each group's [fb(4) | cover(count)] span at a dynamic
    # offset under the per-tile budget B (truncated spans fall back, counted)
    n_halves = len(halves)
    n_groups = len(groups) * 5
    span_max_h = [_align8(CAP_FB + c) for c in caps_list]
    full_budget = 5 * sum(span_max_h)
    budget = full_budget if stage_budget is None else min(stage_budget, full_budget)
    if budget % SEG_CHUNK or budget < SEG_CHUNK * n_groups:
        raise ValueError(f"stage budget {budget} must be a multiple of {SEG_CHUNK} "
                         f"and at least {SEG_CHUNK * n_groups}")
    counts_all = torch.cat([h[1] for h in groups], 1)             # (tiles, G)
    off_arr, span_arr = _compact_layout(counts_all, CAP_FB, budget)
    count_eff = torch.minimum(counts_all, span_arr - CAP_FB)

    # a tap is exact only if every mip half made its cover AND its slot fits
    # the staged span; otherwise the whole tap resolves via the fallback
    covered_t = None
    for hi, h in enumerate(halves):
        ce = count_eff[:, hi * 5:(hi + 1) * 5][..., None, None]
        f = h[6] & (h[2] < ce)
        covered_t = f if covered_t is None else covered_t & f

    cnts, recs, fxs, fys, ids_full = [], [], [], [], []
    span_max = max(span_max_h)
    sel_t = None
    for hi, (page_list, count, slot, intra_t, fx_t1, fy_t1, found) in enumerate(groups):
        if hi < n_halves:
            ok = covered_t
        else:
            # cascade group: resolve where its own (budget-fit) cover held
            ce_c = count_eff[:, hi * 5:(hi + 1) * 5][..., None, None]
            ok = found & (slot < ce_c)
            sel_t = (ok & act_t & ~covered_t).to(torch.int32)
        recs.append(torch.where(ok, (CAP_FB + slot) * 128 + intra_t, fb_slot_t * 128))
        fxs.append(torch.where(ok, fx_t1, fb_fx_t))
        fys.append(torch.where(ok, fy_t1, fb_fy_t))
        idg = torch.cat([fb_list, page_list], -1)
        ids_full.append(torch.nn.functional.pad(idg, (0, span_max - idg.shape[-1])))
        cnts.append(CAP_FB + count_eff[:, hi * 5:(hi + 1) * 5])
    rec_t = torch.cat(recs, 1)
    fx_t = torch.cat(fxs, 1)
    fy_t = torch.cat(fys, 1)
    cnts = torch.cat(cnts, 1)
    trace.count("tex_taps", act_t)
    trace.count("tex_pages_staged", cnts)
    if cascade:
        # per-tile any-cascade flag: kernel C skips the cascade resolve on
        # clean tiles
        casc_any = sel_t.reshape(n_tiles, -1).any(1).to(torch.int32)
        cnts = torch.cat([cnts, casc_any[:, None]], 1)
    ids = _pack_ids(off_arr, span_arr, torch.cat(ids_full, 1), budget)

    # stage: one gather of whole pages from the channel-major atlas view
    n_pages = atlas.data.shape[0] // 128
    pages_cm = atlas.data.reshape(n_pages, 128, 4).transpose(1, 2)   # (P, 4, 128)
    staged = pages_cm[ids.reshape(-1).long()].reshape(n_tiles, budget * 4, 128)
    return off_arr, cnts, staged, rec_t, fx_t, fy_t, tfrac_t, covered_t, sel_t


def _check_plan_args(trilinear, cap_lo, cap_hi, block_cap, stage_budget, cascade, cascade_caps):
    """The plan's knobs as `_plan_and_stage` takes them (raising where it
    raises): (per-cover caps and block caps after the fallback's, casc_mip,
    the staged pages a tile)."""
    cap_casc, bc_casc = cascade_caps[:2]
    casc_mip = cascade_caps[2] if len(cascade_caps) > 2 else 3
    for c in (cap_lo, cap_hi, cap_casc):
        if (c + CAP_FB) % SEG_CHUNK:
            raise ValueError(f"cap {c} + {CAP_FB} fallback pages must be a multiple "
                             f"of {SEG_CHUNK}")
    bc_halves = block_cap if isinstance(block_cap, tuple) else (block_cap, block_cap)
    caps = [cap_lo, cap_hi][: 2 if trilinear else 1]
    bcs = list(bc_halves[: len(caps)])
    if cascade:
        caps.append(cap_casc)
        bcs.append(bc_casc)
    full_budget = 5 * sum(_align8(CAP_FB + c) for c in caps)
    budget = full_budget if stage_budget is None else min(stage_budget, full_budget)
    if budget % SEG_CHUNK or budget < SEG_CHUNK * 5 * len(caps):
        raise ValueError(f"stage budget {budget} must be a multiple of {SEG_CHUNK} "
                         f"and at least {SEG_CHUNK * 5 * len(caps)}")
    return caps, bcs, casc_mip, budget


def _fields_layout(fields: tuple, tile: tuple):
    """(fused, tiles, blocks) of the plan's per-pixel fields: the fused
    G-buffer's raster blocks (pl_tiles (tiles, p, 24), id_tiles (tiles, p,
    1)) of `tile` = (tile_h, tile_w) tiles, or the planar sampler's (tex, u,
    v, lod, active) (H, W[, 5]) taps cut into them."""
    tile_h, tile_w = tile
    if len(fields) == 2:
        n_tiles, p = fields[0].shape[:2]
        if p % 128 or tile_w % 128 or tile_h % 2 or p != tile_h * tile_w:
            raise ValueError(f"fused tiles need tile_w % 128 == 0 and an even tile_h, "
                             f"got {tile_h}x{tile_w} over {p} pixels")
        return True, n_tiles, p // 128
    if len(fields) != 5:
        raise ValueError(f"fields are (pl_tiles, id_tiles) or (tex, u, v, lod, active), "
                         f"got {len(fields)}")
    height, width = fields[1].shape
    if (tile_h * tile_w) % 128 or height % tile_h or width % tile_w:
        raise ValueError(f"a {tile_h}x{tile_w} tile of 128-pixel rows must divide the "
                         f"{height}x{width} frame")
    return False, (height // tile_h) * (width // tile_w), tile_h * tile_w // 128


def tex_plan(atlas: AtlasDevice, fields: tuple, tile: tuple, *, trilinear: bool = True,
             cap_lo: int = 92, cap_hi: int = 44, block_cap=16, stage_budget: int | None = None,
             cascade: bool = False, cascade_caps: tuple = (20, 8, 3)):
    """The texture cache's per-frame plan from the taps' per-pixel fields:
    the tap setup, then `_plan_and_stage`'s mip selection, addressing, page
    covers (kernel B, or I above cap 128) and compact staged-page block.

    `fields` are the fused G-buffer's raster blocks (pl_tiles (tiles, p, 24)
    f32: uv at planes 0-1, use flags 14-18, texture ids 19-23; id_tiles
    (tiles, p, 1) int32), whose taps take the quad-derivative LOD, or the
    planar sampler's taps (tex (H, W, 5) int32 >= 0, u, v (H, W), lod (H, W,
    5), active (H, W, 5) bool) cut into `tile` = (tile_h, tile_w) tiles. Both
    are read in place through their strides. Returns `_plan_and_stage`'s
    (off_arr, cnts, staged, rec_t, fx_t, fy_t, tl_t, covered_t, sel_t) and
    approx_count (() int32: the active taps left to the fallback). Counts
    the frame's active taps and staged pages (`trace.count`: tex_taps,
    tex_pages_staged).

    CUDA tensors launch `csrc/tex_plan.cu`: its tap kernel, kernel B's
    covers (`cover_cuda.fused_cover`: the fallback, each half, the cascade;
    with the cascade, its act plane by a third kernel of the source) and its
    select kernel, two launches of its own a call (three with the cascade);
    CPU tensors take `tex_plan_reference`, the plain version. There is no
    fallback between the two: a CUDA input launches or raises."""
    fused, tiles, blocks = _fields_layout(fields, tile)
    caps, bcs, casc_mip, budget = _check_plan_args(trilinear, cap_lo, cap_hi, block_cap,
                                                   stage_budget, cascade, cascade_caps)
    dev = fields[0].device
    if dev.type == "cpu":
        return tex_plan_reference(atlas, fields, tile, trilinear=trilinear, cap_lo=cap_lo,
                                  cap_hi=cap_hi, block_cap=block_cap, stage_budget=stage_budget,
                                  cascade=cascade, cascade_caps=cascade_caps)
    if dev.type != "cuda":
        raise ValueError(f"tex_plan: unsupported device {dev}")
    _check_fields(fields, fused, dev)
    if not 0 < blocks <= 32:
        raise ValueError(f"kernel B takes 1..32 rows of 128 pixels a tile, got {blocks}")
    if min(bcs) < 1:
        raise ValueError(f"block caps must be at least 1, got {bcs}")
    data = atlas.data
    if data.dtype != torch.int32 or data.shape[1:] != (4,) or not data.is_contiguous():
        raise ValueError(f"atlas.data must be contiguous (P*128, 4) int32, got "
                         f"{tuple(data.shape)} {data.dtype}")
    tile_h, tile_w = tile
    table = fused_tex_table(atlas).to(torch.int32)
    ptrs = [x.data_ptr() for x in fields] + [0] * (5 - len(fields))
    if fused:   # tile blocks (tiles, p, c): pixel p of tile t at t * s0 + p * s1
        planes = [(s[0], 0, 128 * s[1], s[1], s[2]) for s in (x.stride() for x in fields)]
        tx, w = 1, 128
    else:       # (H, W[, 5]) planes cut into tiles, tile t = ty * (W / tile_w) + tx
        planes = [(tile_h * s[0], tile_w * s[1], s[0], s[1], s[2] if len(s) > 2 else 0)
                  for s in (x.stride() for x in fields)]
        tx, w = fields[1].shape[1] // tile_w, tile_w
    planes += [(0,) * 5] * (5 - len(planes))
    n_halves = 2 if trilinear else 1
    n_groups = 5 * len(caps)
    args = (int(fused), (ctypes.c_void_p * 5)(*ptrs),
            (ctypes.c_longlong * 25)(*(v for q in planes for v in q)),
            (ctypes.c_int * 5)(tiles, blocks, tx, w, tile_w), table.data_ptr(), table.shape[0],
            (ctypes.c_int * 5)(int(trilinear), n_halves, int(cascade), casc_mip, budget))
    plane_shape = (tiles, 5, blocks, 128)
    pages = torch.empty((1 + len(caps),) + plane_shape, dtype=torch.int32, device=dev)
    act = torch.empty(plane_shape, dtype=torch.bool, device=dev)
    _TAPS(dev, *args, pages.data_ptr(), act.data_ptr())
    covers = [cover_cuda.fused_cover(pages[0], act, (CAP_FB,) * 5, CAP_FB)]
    for i in range(n_halves):
        covers.append(cover_cuda.fused_cover(pages[1 + i], act, (caps[i],) * 5, bcs[i]))
    if cascade:
        act_c = torch.empty_like(act)
        _CASCADE(dev, act.data_ptr(), covers[1][3].data_ptr(), covers[n_halves][3].data_ptr(),
                 act.numel(), act_c.data_ptr())
        covers.append(cover_cuda.fused_cover(pages[-1], act_c, (caps[-1],) * 5, bcs[-1]))
    off_arr = torch.empty((tiles, n_groups), dtype=torch.int32, device=dev)
    cnts = torch.empty((tiles, n_groups + int(cascade)), dtype=torch.int32, device=dev)
    staged = torch.empty((tiles, budget * 4, 128), dtype=torch.int32, device=dev)
    group_shape = (tiles, n_groups, blocks, 128)
    rec_t = torch.empty(group_shape, dtype=torch.int32, device=dev)
    fx_t = torch.empty(group_shape, dtype=torch.float32, device=dev)
    fy_t = torch.empty(group_shape, dtype=torch.float32, device=dev)
    tl_t = torch.empty(plane_shape, dtype=torch.float32, device=dev)
    covered_t = torch.empty(plane_shape, dtype=torch.bool, device=dev)
    sel_t = torch.empty(plane_shape, dtype=torch.int32, device=dev) if cascade else None
    approx = torch.zeros((), dtype=torch.int32, device=dev)
    _SELECT(dev, *args, data.data_ptr(),
            (ctypes.c_void_p * 16)(*(x.data_ptr() for c in covers for x in c),
                                   *(0,) * (16 - 4 * len(covers))),
            (ctypes.c_int * 4)(*(c[0].shape[-1] for c in covers), *(0,) * (4 - len(covers))),
            (ctypes.c_void_p * 10)(*(x.data_ptr() if x is not None else 0 for x in (
                off_arr, cnts, staged, rec_t, fx_t, fy_t, tl_t, covered_t, sel_t, approx))))
    trace.count("tex_taps", act)
    trace.count("tex_pages_staged", cnts[:, :n_groups])
    return off_arr, cnts, staged, rec_t, fx_t, fy_t, tl_t, covered_t, sel_t, approx


def _check_fields(fields: tuple, fused: bool, dev) -> None:
    """The fields' shapes and dtypes as the kernels read them."""
    if fused:
        n_tiles, p = fields[0].shape[:2]
        want = {"pl_tiles": (fields[0], (n_tiles, p, 24), torch.float32),
                "id_tiles": (fields[1], (n_tiles, p, 1), torch.int32)}
    else:
        hw = tuple(fields[1].shape)
        want = {"tex": (fields[0], hw + (5,), torch.int32), "u": (fields[1], hw, torch.float32),
                "v": (fields[2], hw, torch.float32), "lod": (fields[3], hw + (5,), torch.float32),
                "active": (fields[4], hw + (5,), torch.bool)}
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"{name} must be {shape} {dtype} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")


def tex_plan_reference(atlas: AtlasDevice, fields: tuple, tile: tuple, *, trilinear: bool = True,
                       cap_lo: int = 92, cap_hi: int = 44, block_cap=16,
                       stage_budget: int | None = None, cascade: bool = False,
                       cascade_caps: tuple = (20, 8, 3)):
    """Plain version of `tex_plan`: the fused G-buffer's tap setup (masked
    uv, use flags, texture ids and the quad-derivative LOD) or the planar
    taps tiled, then `_plan_and_stage`; approx_count counts the active taps
    it left uncovered."""
    tile_h, tile_w = tile
    if len(fields) == 2:
        pl_tiles, id_tiles = fields
        n_tiles, p, _ = pl_tiles.shape
        blocks = p // 128
        planes_t = pl_tiles.reshape(n_tiles, blocks, 128, 24).permute(0, 3, 1, 2)
        mask_t = id_tiles.reshape(n_tiles, 1, blocks, 128) >= 0

        uv_t = torch.where(mask_t, planes_t[:, 0:2], 0.0)
        use_t = planes_t[:, 14:19] > 0.5
        tex_t = torch.clamp(planes_t[:, 19:24].to(torch.int32), min=0)
        act_t = use_t & mask_t

        # quad-derivative LOD (gbuffer.tap_lod) in tiled layout
        ddx, ddy = _quad_deltas(uv_t, tile_h, tile_w)
        size5 = onehot_lookup(atlas.base_size.float(), tex_t)
        gx_u = ddx[:, 0][:, None] * size5[..., 0]
        gx_v = ddx[:, 1][:, None] * size5[..., 1]
        gy_u = ddy[:, 0][:, None] * size5[..., 0]
        gy_v = ddy[:, 1][:, None] * size5[..., 1]
        rho2 = torch.maximum(gx_u * gx_u + gx_v * gx_v, gy_u * gy_u + gy_v * gy_v)
        lod_t = 0.5 * torch.log2(torch.clamp(rho2, min=1e-12))
        lod_t = torch.where(mask_t, lod_t, 99.0)

        u5_t = uv_t[:, 0:1].expand(tex_t.shape)
        v5_t = uv_t[:, 1:2].expand(tex_t.shape)
    else:
        tex, u, v, lod, active = fields

        def tile_g(x):  # (H, W, 5) -> (tiles, 5, blocks, 128)
            return _tile(x.permute(2, 0, 1), tile_h, tile_w)

        tex_t, u5_t, v5_t, lod_t, act_t = (
            tile_g(tex), tile_g(u[..., None].expand(tex.shape)),
            tile_g(v[..., None].expand(tex.shape)), tile_g(lod), tile_g(active))
    plan = _plan_and_stage(
        atlas, tex_t, u5_t, v5_t, lod_t, act_t, trilinear=trilinear, cap_lo=cap_lo,
        cap_hi=cap_hi, block_cap=block_cap, stage_budget=stage_budget, cascade=cascade,
        cap_casc=cascade_caps[0], block_cap_casc=cascade_caps[1],
        casc_mip=cascade_caps[2] if len(cascade_caps) > 2 else 3)
    return (*plan, (act_t & ~plan[7]).sum().to(torch.int32))


def sample_atlas_tiled(atlas: AtlasDevice, tex, u, v, lod, active, filter: str = "trilinear",
                       tile_h: int = 24, tile_w: int = 128, cap_lo: int = 92, cap_hi: int = 44,
                       block_cap=16, stage_budget: int | None = None, cascade: bool = False,
                       cascade_caps: tuple = (20, 8, 3)):
    """The planar texture-cache sampler: tex (H, W, 5) int32 >= 0, u/v (H,
    W), lod (H, W, 5), active (H, W, 5) bool taps that must resolve. The tap
    planes are planned on this function's own (tile_h, tile_w) cache tiling
    (`tex_plan`: kernel B, or I above cap 128) and resolved (kernel E).

    Returns (rgba (H, W, 5, 4) storage space, covered (H, W, 5) bool, approx
    (H, W, 5) bool): covered taps are exact (bit-equal to the direct-atlas
    sampler); approx taps overflowed the tile's page budget and resolve at the
    coarsest mip (or, with `cascade`, at the mip_lo+3 re-tap)."""
    height, width = u.shape
    trilinear = filter != "bilinear"
    (off_arr, cnts, staged, rec_t, fx_t, fy_t, tl_t, covered_t, sel_t, _) = tex_plan(
        atlas, (tex, u, v, lod, active), (tile_h, tile_w), trilinear=trilinear, cap_lo=cap_lo,
        cap_hi=cap_hi, block_cap=block_cap, stage_budget=stage_budget, cascade=cascade,
        cascade_caps=cascade_caps)
    trace.stage("gbuffer.tex_resolve", 2)
    out = atlas_resolve_cuda.atlas_resolve(off_arr, cnts, staged, rec_t, fx_t, fy_t, tl_t,
                                           sel_t, trilinear=trilinear)
    rgba = _untile(out, height, width, tile_h, tile_w).permute(2, 3, 0, 1)   # (H, W, 5, 4)
    covered = _untile(covered_t, height, width, tile_h, tile_w).permute(1, 2, 0)
    return rgba, covered, active & ~covered


def sample_atlas_textured(atlas: AtlasDevice, tex, u, v, lod, active,
                          filter: str = "trilinear", block_cap=16, cap_lo: int = 92,
                          cap_hi: int = 44, stage_budget: int | None = None,
                          cascade: bool = False, cascade_caps: tuple = (20, 8, 3)):
    """The texture cache's counterpart of gbuffer.sample_atlas_trilinear:
    exact for covered taps, the coarsest-mip average (or the cascade re-tap)
    for page-budget overflows. Returns (rgba (H, W, 5, 4) with sRGB applied,
    approx (H, W, 5) overflow-tap mask).

    A frame with no cache tiling (`pick_tile` None) samples every tap with
    the direct-atlas sampler and reports no approx taps: that is the
    reference function's contract (JAX texcache.py:1611-1616), not a device
    fallback. The pipeline never reaches it: use_tex_kernel needs a tiling."""
    height, width = u.shape
    tile = pick_tile(height, width)
    if tile is None:
        trace.stage("gbuffer.tex_resolve", 2)
        rgba = gbuffer.sample_atlas_trilinear(atlas, tex.long(), u[..., None], v[..., None],
                                              lod, filter=filter)
        return rgba, torch.zeros(tex.shape, dtype=torch.bool, device=tex.device)
    rgba, _, approx = sample_atlas_tiled(
        atlas, tex, u, v, lod, active, filter=filter, tile_h=tile[0], tile_w=tile[1],
        block_cap=block_cap, cap_lo=cap_lo, cap_hi=cap_hi, stage_budget=stage_budget,
        cascade=cascade, cascade_caps=cascade_caps)
    srgb = onehot_lookup(atlas.srgb.float()[:, None], tex)[..., 0] > 0.5
    rgb = torch.where(srgb[..., None], common.srgb_eotf(rgba[..., :3]), rgba[..., :3])
    return torch.cat([rgb, rgba[..., 3:]], -1), approx


def _quad_deltas(uv_t, tile_h, tile_w):
    """(ddx, ddy) of tiled uv (tiles, 2, blocks, 128): 2x2-quad differences
    (gbuffer._quad_derivatives). Tile origins are even in both axes, so quads
    never straddle tiles; y-pairs are blocks b and b + tile_w/128."""
    n_tiles, _, blocks, _ = uv_t.shape
    wb = tile_w // 128
    x = uv_t.reshape(n_tiles, 2, blocks * 64, 2)
    ddx = (x[..., 1:2] - x[..., 0:1]).expand(x.shape).reshape(uv_t.shape)
    y = uv_t.reshape(n_tiles, 2, tile_h // 2, 2, wb * 128)
    ddy = (y[..., 1:2, :] - y[..., 0:1, :]).expand(y.shape).reshape(uv_t.shape)
    return ddx, ddy


def shade_planes_fused(atlas: AtlasDevice, pl_tiles, id_tiles, height: int, width: int,
                       tile_h: int, tile_w: int, filter: str = "trilinear",
                       cap_lo: int = 92, cap_hi: int = 44, block_cap=16,
                       stage_budget: int | None = None, cascade: bool = False,
                       cascade_caps: tuple = (20, 8, 3), return_tiled: bool = False):
    """The fused G-buffer back half: raster plane blocks pl_tiles (tiles, p,
    24) and ids (tiles, p, 1) -> quantized G-buffer planes. The plan
    (`tex_plan`: the taps' quad-derivative LOD, kernel B's covers, the
    staged pages) and the resolve + pixel shade (kernel C), in tiled layout
    throughout.

    Returns (gb9 (9, H, W) f32 [albedo(3), emission, oct(2), roughness,
    metallic, ao], approx_count () int32); with return_tiled=True,
    (gb_tiles (tiles, 9, blocks, 128), approx_count)."""
    trilinear = filter != "bilinear"
    n_tiles, p, _ = pl_tiles.shape
    (off_arr, cnts, staged, rec_t, fx_t, fy_t, tl_t, _, sel_t, approx_count) = tex_plan(
        atlas, (pl_tiles, id_tiles), (tile_h, tile_w), trilinear=trilinear, cap_lo=cap_lo,
        cap_hi=cap_hi, block_cap=block_cap, stage_budget=stage_budget, cascade=cascade,
        cascade_caps=cascade_caps)
    trace.stage("gbuffer.tex_resolve", 2)

    blocks = p // 128
    planes_t = pl_tiles.reshape(n_tiles, blocks, 128, 24).permute(0, 3, 1, 2)
    mask_t = id_tiles.reshape(n_tiles, 1, blocks, 128) >= 0
    tex_t = torch.clamp(planes_t[:, 19:24].to(torch.int32), min=0)
    srgb5 = onehot_lookup(atlas.srgb.float()[:, None], tex_t)[..., 0] > 0.5
    flags = torch.cat([srgb5, mask_t], 1).to(torch.int32)          # (tiles, 6, b, 128)
    attrs = planes_t[:, 2:19]                                      # (tiles, 17, b, 128)
    gb_tiles = resolve_shade_cuda.resolve_shade(
        off_arr, cnts, staged, rec_t, fx_t, fy_t, tl_t, attrs, flags, sel_t,
        trilinear=trilinear)
    if return_tiled:
        return gb_tiles, approx_count
    return _untile(gb_tiles, height, width, tile_h, tile_w), approx_count


# ------------------------------------------------------------- census -----
def _distinct_counts(rows):
    """Distinct non-SENTINEL values per row of `rows` (n, L) int32, by a sort
    along the row -> (n,) int64 numpy counts on the host."""
    s = torch.sort(rows, dim=-1).values
    first = s[:, :1] != SENTINEL
    rest = (s[:, 1:] != s[:, :-1]) & (s[:, 1:] != SENTINEL)
    return (first.sum(-1) + rest.sum(-1)).cpu().numpy()


def tap_census(atlas: AtlasDevice, tex, u, v, lod, active, filter: str = "trilinear",
               tile_h: int | None = None, tile_w: int | None = None, cap_lo: int = 92,
               cap_hi: int = 44):
    """Measure realized distinct-page demand per (tile, slot, mip-half) of a
    frame's tap stream (tex (H, W, 5) int32, u/v (H, W), lod/active (H, W,
    5)) through the exact addressing of the plan (`_mip_plan` +
    `_tap_addresses`): for each trilinear half the max / p99 / mean distinct
    pages over all (tile, slot) groups and the max / p99.9 over 128-pixel
    rows (what a per-half `block_cap` must hold), and the per-tile total of
    the compact staging spans at the group caps `cap_lo`/`cap_hi`. The sort
    runs on the tensors' device; the counts come to the host and take
    numpy's percentiles, as in the JAX package.

    A tile's rows are padded to a multiple of 8 with absent pages, as the
    JAX package's tiling pads them (its TPU sublane rule): the padded rows
    count 0 distinct pages and enter the row percentile, so the padding is
    kept here or `recommend_block_caps` would size other block caps."""
    height, width = u.shape
    if tile_h is None or tile_w is None:
        t = pick_tile(height, width)
        if t is None:
            raise ValueError(f"no cache tiling for {width}x{height}")
        tile_h, tile_w = t
    trilinear = filter != "bilinear"
    blocks = tile_h * tile_w // 128
    pad = (-blocks) % 8
    blocks += pad

    u5 = u[..., None].expand(tex.shape)
    v5 = v[..., None].expand(tex.shape)
    base_w, base_h, pb, _fb, mips, _tf, _nm = _mip_plan(atlas, tex, lod, trilinear)

    def tile_g(x):  # (H, W, 5) -> (tiles, 5, blocks, 128), unpadded
        return _tile(x.permute(2, 0, 1), tile_h, tile_w)

    act_t = tile_g(active)
    out = {}
    tile_spans = None
    for name, m in zip(("lo", "hi"), mips):
        page, _, _, _ = _tap_addresses(base_w, base_h, select_mip(pb, m), m, u5, v5)
        pg = torch.where(act_t, tile_g(page), SENTINEL)
        pg = torch.nn.functional.pad(pg, (0, 0, 0, pad), value=SENTINEL)
        tiles_n, g = pg.shape[:2]
        counts = _distinct_counts(pg.reshape(tiles_n * g, blocks * 128))
        rcounts = _distinct_counts(pg.reshape(tiles_n * g * blocks, 128))
        out[name] = {
            "max": int(counts.max()),
            "p99": int(np.percentile(counts, 99)),
            "mean": float(counts.mean()),
            "row_max": int(rcounts.max()),
            "row_p999": int(np.percentile(rcounts, 99.9)),
        }
        # staged span per group at its cap: [fb | cover] in SEG_CHUNK steps
        cap_g = cap_lo if name == "lo" else cap_hi
        capped = np.minimum(counts.reshape(tiles_n, g), cap_g)
        span = -(-(CAP_FB + capped) // SEG_CHUNK) * SEG_CHUNK
        tile_spans = span if tile_spans is None else tile_spans + span
        if not trilinear:
            out["hi"] = {"max": 0, "p99": 0, "mean": 0.0}
    totals = tile_spans.sum(-1)
    out["tile_total"] = {
        "max": int(totals.max()),
        "p99": int(np.percentile(totals, 99)),
        "mean": float(totals.mean()),
    }
    return out


def recommend_caps(census_frames, headroom: float = 1.5):
    """Fold per-frame `tap_census` results into (cap_lo, cap_hi): the max
    demand over the frames times `headroom`, aligned so cap + CAP_FB is a
    SEG_CHUNK multiple, never above the defaults 92/44."""
    def align(demand, default):
        want = -(-(int(demand * headroom) + CAP_FB) // SEG_CHUNK) * SEG_CHUNK
        return max(SEG_CHUNK - CAP_FB, min(want - CAP_FB, default))

    max_lo = max(c["lo"]["max"] for c in census_frames)
    max_hi = max(c["hi"]["max"] for c in census_frames)
    return align(max_lo, 92), align(max_hi, 44)


def recommend_block_caps(census_frames, headroom: int = 2, lo_max: int = 40,
                         hi_max: int = 24):
    """Fold per-frame `tap_census` results into a per-half (block_cap_lo,
    block_cap_hi): the p99.9 per-row demand plus `headroom`, rounded up to a
    multiple of 4, clamped to [8, lo_max] and [8, hi_max]."""
    def size(key, cap):
        want = max(c[key]["row_p999"] for c in census_frames) + headroom
        return int(max(8, min(-(-want // 4) * 4, cap)))

    return size("lo", lo_max), size("hi", hi_max)


def recommend_budget(census_frames, headroom: float = 1.5) -> int:
    """Compact-staging per-tile page budget: SEG_CHUNK-aligned, at least the
    worst sampled tile total x headroom and at least 16 x SEG_CHUNK."""
    worst = max(c["tile_total"]["max"] for c in census_frames)
    b = -(-int(worst * headroom) // SEG_CHUNK) * SEG_CHUNK
    return max(b, 16 * SEG_CHUNK)
