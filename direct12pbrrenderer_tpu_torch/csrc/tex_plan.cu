// The texture cache's per-frame plan, from the taps' per-pixel fields to the
// staged page block, in two kernels around kernel B's page covers:
// tex_plan_kernel_taps (the taps' LOD, mips and page addresses: the page
// planes and the act plane the covers read), then kernel B (fused_cover.cu,
// launched by the wrapper: the fallback cover, then the lo and hi halves,
// then with the cascade on its cover, whose act plane tex_plan_kernel_cascade
// takes from the halves' found planes), then tex_plan_kernel_select (the
// compact layout, the tap select and the staging).
//
// Replaces no TPU kernel: it is the XLA glue of the JAX package around kernel
// B's texture launches, direct12pbrrenderer_tpu/ops/texcache.py
// _plan_and_stage and shade_planes_fused's tap setup before it, which the
// port ran as PyTorch ops (about 9.6 ms of a 28 ms 1080p frame: a 17-float
// table row per tap, one address pass per cover, one-hot rows, scatters of
// the page ids and a staging gather through a transposed view). The plain
// version is ops/texcache.py tex_plan_reference, that glue unchanged; the
// outputs are bit-equal to it.
//
// Semantics kept (texcache.tex_plan's docstring). Per pixel, in either input
// layout: the fused G-buffer's raster blocks (uv masked to 0 off the
// triangles, use = plane > 0.5, texture id = max((int)plane, 0), act = use
// and covered, the LOD from the 2x2-quad differences of the masked uv: the x
// partner is the neighbouring pixel, the y partner the same column of the
// paired row) or the planar sampler's taps (tex, u, v, lod, act given). Per
// tap: the texture's table row by id (a zero row outside the table), the lod
// clamped to [0, n_mips - 1], mip_lo its floor (trilinear) or its rounding
// (bilinear), mip_hi = min(mip_lo + 1, n_mips - 1), the cascade's mip
// min(mip_lo + casc_mip, n_mips - 1), a mip outside the table taking page
// base 0; the wrap address x = u * w - 0.5, floor, frac, torch.remainder,
// 16x8-texel pages; every float step one rounding in PyTorch's order
// (--fmad=false, log2f; clamps, minima and maxima pass a NaN as
// torch.clamp, torch.minimum and torch.maximum do; a shift by a negative
// count is torch's >>). Per tile: each group's [fallback | cover] span at a
// SEG_CHUNK-aligned offset under the budget with SEG_CHUNK rows kept for
// every later group, count_eff, the covered mask (every half found and its
// slot within count_eff), each tap's record and fracs (the half's where
// covered, the fallback's elsewhere; the cascade's where its own cover holds),
// the cascade's select mask and the tile's any-cascade column, the taps left
// to the fallback. The staged block holds page p's channel c at row p * 4 + c;
// rows past a group's count hold the cover list's zero padding and rows past
// the last span atlas page 0, as the plain version's scatter of ids leaves
// them.
//
// What bounds it on an H100: bytes. A 1080p frame (675 tiles of 24x128, 5
// slots: 10.4M taps a trilinear half) reads the raster blocks' used planes
// (uv, use, tex and the ids: 52 B a pixel, about 0.1 GB, twice: the select
// kernel reads them again), writes the covers' page planes and the act
// plane (13 B a tap for the fallback, lo and hi: 0.14 GB) and reads them
// back in kernel B, writes B's slot and found planes (5 B a tap a cover) and
// reads them in the select kernel (0.16 GB both ways), writes 33 B a tap of
// records, fracs, the trilinear frac and the covered mask (0.34 GB), and the
// staged block (720 pages of 2 KB a tile: 995 MB), reading the distinct
// pages it stages from the L2: about 2 GB, 0.6 ms at 3.35 TB/s, of which
// the staged block is half. The design:
//   * the fields are read in place through their strides (the raster's
//     channel-innermost tile blocks, or the planar (H, W[, 5]) planes cut
//     into tiles), and no per-tap plane is built but the covers' inputs: the
//     select kernel recomputes a tap's LOD and address from the pixel's
//     fields instead of reading them back, and only the address it keeps;
//   * a quad's x partner is the neighbouring lane (a shuffle), its y
//     partner one load of the paired row's uv and id;
//   * the table is indexed by texture id (17 ints a texture, cached);
//   * one block a tile: one thread lays the tile's 5 to 15 groups out, then
//     the block's threads select the tile's taps (coalesced per group plane)
//     and count the fallback taps, one atomic a warp; then its warps stage
//     one page each at a time: a page's 128 records of 4 words read as
//     16-byte loads, turned through shared memory and written as 128-word
//     rows of 16-byte stores, both coalesced. A page's id is found from the
//     layout as the warp reaches it, so no budget bounds the kernel. Staging
//     in blocks of their own, 128 pages each beside a block of taps a tile,
//     measured no faster on an H100 (0.758 ms against 0.749 for the select
//     kernel on a 1080p frame): the bytes bound both.
// Kernel B stays one launch a cover, as in the env plan (csrc/env_plan.cu).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 5;          // material slots a pixel
constexpr int kMaxHalves = 2;      // trilinear lo and hi
constexpr int kMaxCovers = 4;      // fallback, lo, hi, cascade
constexpr int kMaxGroups = kSlots * (kMaxHalves + 1);
constexpr int kCapFb = 4;          // fallback pages a group (texcache.CAP_FB)
constexpr int kSegChunk = 8;       // staged-span granularity (texcache.SEG_CHUNK)
constexpr int kMaxMips = 13;       // texcache.MAX_MIPS
constexpr int kRow = 4 + kMaxMips; // table row [n_mips, base_w, base_h, fb_page, page_base]
constexpr int kRecI32 = 4;         // words a record
constexpr int kRecords = 128;      // records a page
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;            // a transpose row's padding: rows stay 16-byte aligned
constexpr int kUse = 14, kTex = 19;  // the raster blocks' use flags and texture ids
constexpr float kTiny = (float)1e-12;  // the squared gradient's floor (tap_lod)
constexpr unsigned kFull = 0xffffffffu;

// One field's element offset of pixel p of tile t:
// (t / tx) * a + (t % tx) * b + (p / w) * c + (p % w) * e, and its slot or
// channel stride ch.
struct Plane {
  long long a, b, c, e, ch;
};

// The per-pixel fields. Fused: f[0] the raster blocks (tiles, p, 24) f32,
// f[1] the ids (tiles, p, 1) int32. Planar: f[0] tex (.., 5) int32, f[1] u,
// f[2] v f32, f[3] lod (.., 5) f32, f[4] act (.., 5) bool.
struct Fields {
  const void* f[5];
  Plane q[5];
  int fused, tx, w, tile_w;
};

struct Atlas {
  const int* table;  // (n_tex, kRow)
  int n_tex;
  const int* data;   // (pages * 128, 4) records
};

struct Plan {
  int trilinear, n_halves, cascade, casc_mip, budget;
};

__device__ __forceinline__ long long offset_of(const Plane& q, int tx, int w, int t, int p) {
  return (long long)(t / tx) * q.a + (long long)(t % tx) * q.b + (long long)(p / w) * q.c +
         (long long)(p % w) * q.e;
}

__device__ __forceinline__ bool isnan_(float x) { return x != x; }
// torch.clamp(x, min=lo): a NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan_(x) ? x : fmaxf(x, lo);
}
// torch.maximum and torch.minimum: a NaN on either side gives a quiet NaN
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan_(a) || isnan_(b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan_(a) || isnan_(b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
// torch's >> on int32: a count below 0 or above 30 shifts by 31
__device__ __forceinline__ int shr(int a, int b) { return b < 0 || b >= 31 ? a >> 31 : a >> b; }
// torch.remainder on int32: the sign of the divisor
__device__ __forceinline__ int remainder(int a, int b) {
  const int r = a % b;
  return r != 0 && ((r < 0) != (b < 0)) ? r + b : r;
}

// column `col` of texture `tex`'s table row, 0 outside the table (the plain
// version's one-hot lookup)
__device__ __forceinline__ int tab(const Atlas& at, int tex, int col) {
  return tex >= 0 && tex < at.n_tex ? __ldg(at.table + (size_t)tex * kRow + col) : 0;
}

// What a pixel's taps share and hold.
struct Pixel {
  float u, v;
  int tex[kSlots];
  float lod[kSlots];
  bool act[kSlots];
};

template <typename T>
__device__ __forceinline__ T field(const Fields& f, int i, long long o) {
  return __ldg(static_cast<const T*>(f.f[i]) + o);
}

// The fused G-buffer's tap setup (shade_planes_fused before its plan): the
// masked uv, use flags, ids and act, and the quad-derivative LOD. Every lane
// of the warp takes part (the x partner's uv comes by shuffle).
__device__ __forceinline__ void load_fused(const Fields& f, const Atlas& at, int t, int p,
                                           Pixel& px) {
  const Plane& pq = f.q[0];
  const long long o = offset_of(pq, f.tx, f.w, t, p);
  const bool mask = field<int>(f, 1, offset_of(f.q[1], f.tx, f.w, t, p)) >= 0;
  px.u = mask ? field<float>(f, 0, o) : 0.0f;
  px.v = mask ? field<float>(f, 0, o + pq.ch) : 0.0f;
  // the quad's x partner is pixel p ^ 1 (tile_w is even), the neighbouring lane
  const float ux = __shfl_xor_sync(kFull, px.u, 1), vx = __shfl_xor_sync(kFull, px.v, 1);
  // its y partner the same column of the paired row
  const int row = p / f.tile_w, col = p - row * f.tile_w;
  const int py = (row ^ 1) * f.tile_w + col;
  const long long oy = offset_of(pq, f.tx, f.w, t, py);
  const bool mask_y = field<int>(f, 1, offset_of(f.q[1], f.tx, f.w, t, py)) >= 0;
  const float uy = mask_y ? field<float>(f, 0, oy) : 0.0f;
  const float vy = mask_y ? field<float>(f, 0, oy + pq.ch) : 0.0f;
  // pixel 2k+1 less pixel 2k; row 2k+1 less row 2k
  const float ddx_u = p & 1 ? __fsub_rn(px.u, ux) : __fsub_rn(ux, px.u);
  const float ddx_v = p & 1 ? __fsub_rn(px.v, vx) : __fsub_rn(vx, px.v);
  const float ddy_u = row & 1 ? __fsub_rn(px.u, uy) : __fsub_rn(uy, px.u);
  const float ddy_v = row & 1 ? __fsub_rn(px.v, vy) : __fsub_rn(vy, px.v);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const bool use = field<float>(f, 0, o + (kUse + s) * pq.ch) > 0.5f;
    px.tex[s] = max((int)field<float>(f, 0, o + (kTex + s) * pq.ch), 0);
    px.act[s] = use && mask;
    const float sw = (float)tab(at, px.tex[s], 1), sh = (float)tab(at, px.tex[s], 2);
    const float gx_u = __fmul_rn(ddx_u, sw), gx_v = __fmul_rn(ddx_v, sh);
    const float gy_u = __fmul_rn(ddy_u, sw), gy_v = __fmul_rn(ddy_v, sh);
    const float rho2 = maximum(__fadd_rn(__fmul_rn(gx_u, gx_u), __fmul_rn(gx_v, gx_v)),
                               __fadd_rn(__fmul_rn(gy_u, gy_u), __fmul_rn(gy_v, gy_v)));
    const float lod = __fmul_rn(0.5f, log2f(clamp_min(rho2, kTiny)));
    px.lod[s] = mask ? lod : 99.0f;
  }
}

// The planar sampler's taps, as given.
__device__ __forceinline__ void load_planar(const Fields& f, int t, int p, Pixel& px) {
  px.u = field<float>(f, 1, offset_of(f.q[1], f.tx, f.w, t, p));
  px.v = field<float>(f, 2, offset_of(f.q[2], f.tx, f.w, t, p));
  const long long ot = offset_of(f.q[0], f.tx, f.w, t, p);
  const long long ol = offset_of(f.q[3], f.tx, f.w, t, p);
  const long long oa = offset_of(f.q[4], f.tx, f.w, t, p);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    px.tex[s] = field<int>(f, 0, ot + s * f.q[0].ch);
    px.lod[s] = field<float>(f, 3, ol + s * f.q[3].ch);
    px.act[s] = field<uint8_t>(f, 4, oa + s * f.q[4].ch) != 0;
  }
}

__device__ __forceinline__ void load_pixel(const Fields& f, const Atlas& at, int t, int p,
                                           Pixel& px) {
  if (f.fused) {
    load_fused(f, at, t, p, px);
  } else {
    load_planar(f, t, p, px);
  }
}

// A tap's table row and mips (texcache._mip_plan): m[0] mip_lo, m[1]
// mip_hi, m[2] the cascade's mip.
struct Mips {
  int base_w, base_h, fb_page;
  int m[3];
  float tfrac;
};

__device__ __forceinline__ Mips mips_of(const Atlas& at, const Plan& pl, int tex, float lod) {
  Mips r;
  const int n_mips = tab(at, tex, 0);
  r.base_w = tab(at, tex, 1);
  r.base_h = tab(at, tex, 2);
  r.fb_page = tab(at, tex, 3);
  const float l = minimum(clamp_min(lod, 0.0f), (float)(n_mips - 1));
  if (pl.trilinear) {
    r.m[0] = (int)floorf(l);
    r.tfrac = __fsub_rn(l, (float)r.m[0]);
  } else {
    r.m[0] = (int)rintf(l);
    r.tfrac = 0.0f;
  }
  r.m[1] = min(r.m[0] + 1, n_mips - 1);
  r.m[2] = min(r.m[0] + pl.casc_mip, n_mips - 1);
  return r;
}

struct Addr {
  int page, intra;
  float fx, fy;
};

// texcache._tap_addresses at mip `mip`: the wrap address, 16x8-texel pages
// from the mip's page base (select_mip: 0 for a mip outside the table)
__device__ __forceinline__ Addr address(const Atlas& at, int tex, const Mips& r, int mip, float u,
                                        float v) {
  const int pb = mip >= 0 && mip < kMaxMips ? tab(at, tex, 4 + mip) : 0;
  const int w = max(shr(r.base_w, mip), 1), h = max(shr(r.base_h, mip), 1);
  const float x = __fsub_rn(__fmul_rn(u, (float)w), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, (float)h), 0.5f);
  const float x0f = floorf(x), y0f = floorf(y);
  Addr a;
  a.fx = __fsub_rn(x, x0f);
  a.fy = __fsub_rn(y, y0f);
  const int x0 = remainder((int)x0f, w), y0 = remainder((int)y0f, h);
  a.page = pb + (y0 >> 3) * ((w + 15) >> 4) + (x0 >> 4);
  a.intra = (y0 & 7) * 16 + (x0 & 15);
  return a;
}

// The page planes of kernel B's covers: one thread a pixel, for each slot
// the fallback page (cover 0), each half's page (covers 1..n_halves) and the
// cascade's (the last cover, with the cascade on) at (k, t, s, p) of (covers,
// tiles, 5, npix), and the act plane at (t, s, p).
__global__ void __launch_bounds__(kThreads)
    tex_plan_kernel_taps(Fields f, Atlas at, Plan pl, int n_px, int npix, int tiles, int* pages,
                         uint8_t* act) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_px) return;   // n_px is a multiple of 128: whole warps leave
  const int t = i / npix, p = i - t * npix;
  Pixel px;
  load_pixel(f, at, t, p, px);
  const size_t plane = (size_t)tiles * kSlots * npix;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const size_t o = ((size_t)t * kSlots + s) * npix + p;
    const Mips r = mips_of(at, pl, px.tex[s], px.lod[s]);
    pages[o] = r.fb_page;
    for (int h = 0; h < pl.n_halves; ++h) {
      pages[(1 + h) * plane + o] = address(at, px.tex[s], r, r.m[h], px.u, px.v).page;
    }
    if (pl.cascade) {
      pages[(1 + pl.n_halves) * plane + o] = address(at, px.tex[s], r, r.m[2], px.u, px.v).page;
    }
    act[o] = px.act[s];
  }
}

// The cascade cover's act plane: act & ~(found_lo & found_hi), 16 taps a
// thread (the planes are 0/1 bytes, 16-byte aligned, n16 words of 16 bytes).
__global__ void __launch_bounds__(kThreads)
    tex_plan_kernel_cascade(const uint4* act, const uint4* lo, const uint4* hi, long long n16,
                            uint4* out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n16) return;
  const uint4 a = act[i], l = lo[i], h = hi[i];
  out[i] = make_uint4(a.x & ~(l.x & h.x), a.y & ~(l.y & h.y), a.z & ~(l.z & h.z),
                      a.w & ~(l.w & h.w));
}

// Kernel B's outputs for one cover.
struct Cover {
  const int* list;       // (tiles, 5, width) ascending pages, 0-padded
  const int* count;      // (tiles, 5)
  const int* slot;       // (tiles, 5, npix)
  const uint8_t* found;  // (tiles, 5, npix) its covered taps
  int width;
};

struct Covers {
  Cover c[kMaxCovers];
};

struct Out {
  int* off;          // (tiles, G)
  int* cnts;         // (tiles, G [+ 1: the any-cascade column])
  int* staged;       // (tiles, budget * 4, 128)
  int* rec;          // (tiles, G, npix)
  float* fx;
  float* fy;
  float* tl;         // (tiles, 5, npix) the trilinear frac
  uint8_t* covered;  // (tiles, 5, npix)
  int* sel;          // (tiles, 5, npix) the cascade's select, with the cascade on
  int* approx;       // () the taps left to the fallback
};

// One tap's record and fracs: the group's own where `ok`, the fallback's
// elsewhere.
__device__ __forceinline__ void select_tap(const Out& o, size_t og, bool ok, const Addr& a,
                                           int slot, int fb_rec, float fb_fx, float fb_fy) {
  o.rec[og] = ok ? (kCapFb + slot) * kRecords + a.intra : fb_rec;
  o.fx[og] = ok ? a.fx : fb_fx;
  o.fy[og] = ok ? a.fy : fb_fy;
}

// The taps of tile t: covered, each group's record and fracs, tl and sel;
// the taps left to the fallback, one atomic a warp; the any-cascade column.
__device__ __forceinline__ void select_taps(const Fields& f, const Atlas& at, const Plan& pl,
                                            const Covers& cv, const Out& o, int npix, int t,
                                            int n_g, int n_cols, const int* s_ceff) {
  const int lane = threadIdx.x & 31;
  // npix is a multiple of 128, so a warp's lanes are all in or all out
  int approx = 0;
  bool any_sel = false;
  for (int p = threadIdx.x; p < npix; p += kThreads) {
    Pixel px;
    load_pixel(f, at, t, p, px);
    // the guaranteed fallback tap: the coarsest mip's 1x1 page
    const float fb_fx = __fsub_rn(__fsub_rn(px.u, 0.5f), floorf(__fsub_rn(px.u, 0.5f)));
    const float fb_fy = __fsub_rn(__fsub_rn(px.v, 0.5f), floorf(__fsub_rn(px.v, 0.5f)));
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const size_t o5 = ((size_t)t * kSlots + s) * npix + p;
      const Mips r = mips_of(at, pl, px.tex[s], px.lod[s]);
      const int fb_rec = __ldg(cv.c[0].slot + o5) * kRecords;
      // a tap is exact only if every half made its cover and its slot fits
      // the staged span
      int slot[kMaxHalves];
      bool cov = true;
      for (int h = 0; h < pl.n_halves; ++h) {
        slot[h] = __ldg(cv.c[1 + h].slot + o5);
        cov = cov && __ldg(cv.c[1 + h].found + o5) && slot[h] < s_ceff[h * kSlots + s];
      }
      for (int h = 0; h < pl.n_halves; ++h) {
        const size_t og = ((size_t)t * n_g + h * kSlots + s) * npix + p;
        const Addr a = cov ? address(at, px.tex[s], r, r.m[h], px.u, px.v) : Addr{};
        select_tap(o, og, cov, a, slot[h], fb_rec, fb_fx, fb_fy);
      }
      if (pl.cascade) {
        // the cascade group resolves where its own (budget-fit) cover held
        const int g = pl.n_halves * kSlots + s;
        const Cover& c = cv.c[1 + pl.n_halves];
        const int slot_c = __ldg(c.slot + o5);
        const bool ok = __ldg(c.found + o5) && slot_c < s_ceff[g];
        const Addr a = ok ? address(at, px.tex[s], r, r.m[2], px.u, px.v) : Addr{};
        select_tap(o, ((size_t)t * n_g + g) * npix + p, ok, a, slot_c, fb_rec, fb_fx, fb_fy);
        const bool sel = ok && px.act[s] && !cov;
        o.sel[o5] = sel;
        any_sel = any_sel || sel;
      }
      o.tl[o5] = r.tfrac;
      o.covered[o5] = cov;
      approx += px.act[s] && !cov;
    }
  }
  approx = __reduce_add_sync(kFull, approx);
  if (lane == 0 && approx) atomicAdd(o.approx, approx);
  // the tile's any-cascade column (kernel C skips the cascade on clean
  // tiles); the block's barrier after the taps
  const bool any = __syncthreads_or(any_sel);
  if (pl.cascade && threadIdx.x == 0) o.cnts[t * n_cols + n_g] = any;
}

// Tile t's staged block: a warp a page, turned through shared memory (`tr`,
// the warp's).
__device__ __forceinline__ void stage_pages(const Atlas& at, const Plan& pl, const Covers& cv,
                                            const Out& o, int t, int n_g, const int* s_off,
                                            const int* s_span, int (*tr)[kRecords + kPad]) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < pl.budget; j += kWarps) {
    // the page at row j (texcache._pack_ids): its group's fallback list,
    // then its cover list; atlas page 0 past the last span
    int id = 0;
    for (int g = 0; g < n_g; ++g) {
      const int k = j - s_off[g];
      if (k >= 0 && k < s_span[g]) {
        const int ts = t * kSlots + g % kSlots;
        const Cover& c = k < kCapFb ? cv.c[0] : cv.c[1 + g / kSlots];
        id = __ldg(c.list + (size_t)ts * c.width + (k < kCapFb ? k : k - kCapFb));
      }
    }
    const int4* src = reinterpret_cast<const int4*>(at.data + (size_t)id * kRecords * kRecI32);
    int4 v[kRecI32];
#pragma unroll
    for (int q = 0; q < kRecI32; ++q) v[q] = __ldg(src + lane + 32 * q);
#pragma unroll
    for (int q = 0; q < kRecI32; ++q) {   // int4 i holds record i's four words
      const int i = lane + 32 * q;
      tr[0][i] = v[q].x;
      tr[1][i] = v[q].y;
      tr[2][i] = v[q].z;
      tr[3][i] = v[q].w;
    }
    __syncwarp();
    int4* dst =
        reinterpret_cast<int4*>(o.staged + ((size_t)t * pl.budget + j) * kRecI32 * kRecords);
#pragma unroll
    for (int c = 0; c < kRecI32; ++c) {
      dst[lane + 32 * c] = *reinterpret_cast<const int4*>(&tr[c][lane * 4]);
    }
    __syncwarp();
  }
}

// One block a tile: layout, select, staging.
__global__ void __launch_bounds__(kThreads)
    tex_plan_kernel_select(Fields f, Atlas at, Plan pl, Covers cv, Out o, int npix) {
  __shared__ int s_off[kMaxGroups], s_span[kMaxGroups], s_ceff[kMaxGroups];
  __shared__ __align__(16) int s_tr[kWarps][kRecI32][kRecords + kPad];
  const int t = blockIdx.x;
  const int n_g = kSlots * (pl.n_halves + pl.cascade), n_cols = n_g + pl.cascade;

  // ---- the compact layout (texcache._compact_layout), one thread ---------
  if (threadIdx.x == 0) {
    int off = 0;
    for (int g = 0; g < n_g; ++g) {
      const int cnt = cv.c[1 + g / kSlots].count[t * kSlots + g % kSlots];
      const int want = (kCapFb + cnt + kSegChunk - 1) / kSegChunk * kSegChunk;
      const int span = min(want, pl.budget - off - kSegChunk * (n_g - 1 - g));
      const int ceff = min(cnt, span - kCapFb);
      s_off[g] = off;
      s_span[g] = span;
      s_ceff[g] = ceff;
      o.off[t * n_g + g] = off;
      o.cnts[t * n_cols + g] = kCapFb + ceff;
      off += span;
    }
  }
  __syncthreads();
  select_taps(f, at, pl, cv, o, npix, t, n_g, n_cols, s_ceff);
  stage_pages(at, pl, cv, o, t, n_g, s_off, s_span, s_tr[threadIdx.x >> 5]);
}

// fields: the five field pointers (Fields.f); planes: five (a, b, c, e, ch);
// shape: [tiles, blocks, tx, w, tile_w]; plan: [trilinear, n_halves,
// cascade, casc_mip, budget].
bool fields_of(int fused, const void* const* fields, const long long* planes, const int* shape,
               Fields* f) {
  for (int i = 0; i < 5; ++i) {
    f->f[i] = fields[i];
    f->q[i] = Plane{planes[5 * i], planes[5 * i + 1], planes[5 * i + 2], planes[5 * i + 3],
                    planes[5 * i + 4]};
  }
  f->fused = fused;
  f->tx = shape[2];
  f->w = shape[3];
  f->tile_w = shape[4];
  return shape[0] >= 0 && shape[1] >= 1 && f->tx >= 1 && f->w >= 1 &&
         (!fused || (f->tile_w >= 2 && f->tile_w % 2 == 0 && shape[1] * kRecords % f->tile_w == 0 &&
                     shape[1] * kRecords / f->tile_w % 2 == 0));
}

bool plan_of(const int* a, Plan* pl) {
  *pl = Plan{a[0], a[1], a[2], a[3], a[4]};
  const int n_g = kSlots * (pl->n_halves + (pl->cascade != 0));
  return pl->n_halves >= 1 && pl->n_halves <= kMaxHalves && (pl->cascade == 0 || pl->cascade == 1) &&
         pl->n_halves == 2 - (pl->trilinear == 0) && pl->budget >= kSegChunk * n_g &&
         pl->budget % kSegChunk == 0;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
// `pages` (covers, tiles, 5, blocks, 128) int32 and `act` (tiles, 5, blocks,
// 128) bool are written.
extern "C" int tex_plan_taps_launch(int fused, const void* const* fields, const long long* planes,
                                    const int* shape, const int* table, int n_tex,
                                    const int* plan, int* pages, uint8_t* act, void* stream) {
  Fields f;
  Plan pl;
  if (!fields_of(fused, fields, planes, shape, &f) || !plan_of(plan, &pl) || n_tex < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_px = (long long)shape[0] * shape[1] * kRecords;
  if (n_px == 0) return 0;
  if (n_px * kSlots * (1 + pl.n_halves + pl.cascade) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  tex_plan_kernel_taps<<<(unsigned)((n_px + kThreads - 1) / kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>(f, Atlas{table, n_tex, nullptr}, pl, (int)n_px,
                                                 shape[1] * kRecords, shape[0], pages, act);
  return (int)cudaGetLastError();
}

// `out` = act & ~(found_lo & found_hi) over `n` bytes (a multiple of 16; all
// four 16-byte aligned).
extern "C" int tex_plan_cascade_launch(const uint8_t* act, const uint8_t* found_lo,
                                       const uint8_t* found_hi, long long n, uint8_t* out,
                                       void* stream) {
  if (n < 0 || n % 16 ||
      (reinterpret_cast<uintptr_t>(act) | reinterpret_cast<uintptr_t>(found_lo) |
       reinterpret_cast<uintptr_t>(found_hi) | reinterpret_cast<uintptr_t>(out)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n16 = n / 16;
  if (n16 == 0) return 0;
  tex_plan_kernel_cascade<<<(unsigned)((n16 + kThreads - 1) / kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(act), reinterpret_cast<const uint4*>(found_lo),
      reinterpret_cast<const uint4*>(found_hi), n16, reinterpret_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// `covers`: for the fallback, each half and the cascade in turn, kernel B's
// list, count, slot and found; `widths` their lists' widths. `outs`: off,
// cnts, staged, rec, fx, fy, tl, covered, sel (null without the cascade),
// approx (accumulated into).
extern "C" int tex_plan_select_launch(int fused, const void* const* fields,
                                      const long long* planes, const int* shape,
                                      const int* table, int n_tex, const int* plan,
                                      const int* data, const void* const* covers,
                                      const int* widths, void* const* outs, void* stream) {
  Fields f;
  Plan pl;
  if (!fields_of(fused, fields, planes, shape, &f) || !plan_of(plan, &pl) || n_tex < 0 ||
      (reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(outs[2])) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_cov = 1 + pl.n_halves + pl.cascade;
  Covers cv{};
  for (int k = 0; k < n_cov; ++k) {
    cv.c[k] = Cover{static_cast<const int*>(covers[4 * k]),
                    static_cast<const int*>(covers[4 * k + 1]),
                    static_cast<const int*>(covers[4 * k + 2]),
                    static_cast<const uint8_t*>(covers[4 * k + 3]), widths[k]};
    if (widths[k] < (k == 0 ? kCapFb : 1)) return (int)cudaErrorInvalidValue;
  }
  if (shape[0] == 0) return 0;
  const long long npix = (long long)shape[1] * kRecords;
  if ((long long)shape[0] * kSlots * (pl.n_halves + pl.cascade) * npix > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Out o{static_cast<int*>(outs[0]),   static_cast<int*>(outs[1]),   static_cast<int*>(outs[2]),
        static_cast<int*>(outs[3]),   static_cast<float*>(outs[4]), static_cast<float*>(outs[5]),
        static_cast<float*>(outs[6]), static_cast<uint8_t*>(outs[7]), static_cast<int*>(outs[8]),
        static_cast<int*>(outs[9])};
  tex_plan_kernel_select<<<shape[0], kThreads, 0, (cudaStream_t)stream>>>(
      f, Atlas{table, n_tex, data}, pl, cv, o, (int)npix);
  return (int)cudaGetLastError();
}
