// The env cache's per-frame plan, from the deferred pass's per-pixel fields
// to the staged page block, in two kernels around kernel B's page cover:
// env_plan_kernel_taps (tap setup and addressing: the page plane the cover
// reads), then kernel B (fused_cover.cu, launched by the wrapper), then
// env_plan_kernel_select (the compact layout, the tap select and the staging).
//
// Replaces no TPU kernel: it is the XLA glue of the JAX package around kernel
// B's env launch, direct12pbrrenderer_tpu/ops/shading.py env_tap_groups
// (:93) and ops/envcache.py plan_env_tiled (:312), which the port ran as
// PyTorch ops (about 10 ms of a 37 ms 1080p frame: an 18-float table row per
// tap, two address passes, select loops and a staging gather through a
// transposed view). The plain version is ops/envcache.py env_plan_reference,
// that glue unchanged; the outputs are bit-equal to it.
//
// Semantics kept (envcache.env_plan's docstring): per pixel the G = 4 or 5
// tap groups (env trilinear halves lo/hi, BRDF LUT, background sky, with env
// content the mip+3 cascade), each tap's table row read by its texture id (a
// zero row outside the table), the clamp-addressed page, record and fracs of
// the main tap and of the one-page fallback tap, every float step one
// rounding in PyTorch's order (--fmad=false, IEEE division; clamps let a NaN
// through, as torch.clamp does). Per tile: the layout of each group's
// [fallback | cover] span at a SEG_CHUNK-aligned offset under the budget with
// SEG_CHUNK rows kept for every later group, count_eff, the budget fit, the
// shared cover of groups 0 and 1, and each tap's record and fracs: the main
// tap's where covered, the fallback's elsewhere. The staged block holds page
// p's value pair k at row p * 8 + k; rows past a group's count hold the list's
// zero padding and rows past the last span atlas page 0, as the plain
// version's scatter of ids leaves them.
//
// What bounds it on an H100: bytes. A 1080p frame (675 tiles of 24x128, five
// groups: 10.4M taps) reads 33 B of fields a pixel (68 MB), writes 13 B a tap
// (rec, fx, fy, covered: 135 MB) and the staged block (184 pages of 4 KB a
// tile: 509 MB), and reads the distinct pages it stages (31,587 on the traced
// terrain frame: 130 MB): 0.84 GB, 0.25 ms at 3.35 TB/s. Kernel B's plane
// (page and act, 5 B a tap) is written, read, and its slot and cover (5 B a
// tap) written and read again: 0.21 GB more. The design:
//   * the fields are read in place through their strides, in either layout
//     (the fused pass's (tiles, blocks, 128) blocks, the unfused pass's
//     (H, W) image cut into tiles), and no per-tap plane is built but the
//     cover's: the select kernel recomputes a tap's address from the pixel's
//     fields instead of reading it back, and only the address it keeps (the
//     main tap's or the fallback's);
//   * the table is indexed by texture id (18 ints a texture, cached), and a
//     tap's fallback slot is a few compares against its group's static list;
//   * one block a tile: one thread lays the tile's groups out, then the
//     block's threads select the tile's taps (coalesced per group plane) and
//     its warps stage one page each at a time: a page's 128 records of 8
//     words read as 16-byte loads, turned through shared memory and written
//     as 128-word rows of 16-byte stores, both coalesced. A warp-count of
//     the taps left to the fallback goes to env_approx by one atomic.
// Kernel B stays one launch of its own: it is the cover of the texture plans
// too, and a tile-resident copy of its body would keep every candidate and
// rank of five groups resident with the taps' addresses (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 5;
constexpr int kCapFb = 8;        // fallback pages a group (envcache.CAP_FB)
constexpr int kSegChunk = 8;     // staged-span granularity (texcache.SEG_CHUNK)
constexpr int kMaxMips = 13;     // texcache.MAX_MIPS
constexpr int kRow = 5 + kMaxMips;  // table row [base_w, base_h, fb_page, fb_w, fb_h, page_base]
constexpr int kRecI32 = 8;       // packed words a record
constexpr int kRecords = 128;    // records a page
constexpr int kMaxBudget = 256;  // staged pages a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;          // a transpose row's padding: rows stay 16-byte aligned
constexpr float kEps = 1e-6f;    // common.EPSILON
constexpr float kMipLevels = 5.0f;  // config.PREFILTER_ENVMAP_MIP_LEVELS

// One input's element offset of pixel p of tile t:
// (t / tx) * a + (t % tx) * b + (p / w) * c + (p % w) * e.
struct Plane {
  long long a, b, c, e;
};

struct Inputs {
  const float* refl;   // (..., 3)
  const float* ray;    // (..., 3)
  const float* rough;
  const float* ndv;
  const uint8_t* mask;
  Plane refl_p, ray_p, rough_p, ndv_p, mask_p;
  long long refl_ch, ray_ch;  // the vectors' component strides
  int tx, w;
};

// The tap groups' static part (envcache.env_groups): the fallback lists are
// padded to kCapFb with their first texture.
struct Groups {
  int g, env_base, sky_base, lut_tid, env_mips;
  int fb_n[kMaxGroups];
  int fb_tid[kMaxGroups][kCapFb];
};

struct Atlas {
  const int* table;  // (n_tex, kRow)
  int n_tex;
  const int* data;   // (pages * 128, 8) packed records
};

__device__ __forceinline__ long long offset_of(const Plane& q, int tx, int w, int t, int p) {
  return (long long)(t / tx) * q.a + (long long)(t % tx) * q.b + (long long)(p / w) * q.c +
         (long long)(p % w) * q.e;
}

// torch.clamp's bounds and torch.minimum against a number: a NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// column `col` of texture `tex`'s table row, 0 outside the table (the plain
// version's one-hot lookup)
__device__ __forceinline__ int tab(const Atlas& atlas, int tex, int col) {
  return tex >= 0 && tex < atlas.n_tex ? __ldg(atlas.table + (size_t)tex * kRow + col) : 0;
}

struct Cube {
  int face;
  float u, v;
};

// common.cubemap_coords: the D3D face pick (x wins strict, then y strict, else
// z), 1 / max(major, eps) (reciprocal then * 1.0: one rounding), (u + 1) * 0.5
__device__ __forceinline__ Cube cube(float x, float y, float z) {
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = ax > ay && ax > az;
  const bool is_y = !is_x && ay > ax && ay > az;
  const float inv = __fdiv_rn(1.0f, clamp_min(is_x ? ax : (is_y ? ay : az), kEps));
  const float u = is_x ? __fmul_rn(x > 0.0f ? -z : z, inv)
                       : (is_y ? __fmul_rn(x, inv) : __fmul_rn(z > 0.0f ? x : -x, inv));
  const float v = is_x ? __fmul_rn(-y, inv)
                       : (is_y ? __fmul_rn(y > 0.0f ? z : -z, inv) : __fmul_rn(-y, inv));
  Cube c;
  c.face = is_x ? (x > 0.0f ? 0 : 1) : (is_y ? (y > 0.0f ? 2 : 3) : (z > 0.0f ? 4 : 5));
  c.u = __fmul_rn(__fadd_rn(u, 1.0f), 0.5f);
  c.v = __fmul_rn(__fadd_rn(v, 1.0f), 0.5f);
  return c;
}

// What a pixel's taps share (shading.env_tap_groups)
struct Pixel {
  Cube e, s;   // the reflection's and the view ray's cube coordinates
  float rough, ndv;
  int lo, hi, lo3;
  bool mask;
};

__device__ __forceinline__ Pixel load_pixel(const Inputs& in, const Groups& gr, int t, int p) {
  const long long r = offset_of(in.refl_p, in.tx, in.w, t, p);
  const long long q = offset_of(in.ray_p, in.tx, in.w, t, p);
  Pixel px;
  px.e = cube(__ldg(in.refl + r), __ldg(in.refl + r + in.refl_ch),
              __ldg(in.refl + r + 2 * in.refl_ch));
  px.s = cube(__ldg(in.ray + q), __ldg(in.ray + q + in.ray_ch), __ldg(in.ray + q + 2 * in.ray_ch));
  px.rough = __ldg(in.rough + offset_of(in.rough_p, in.tx, in.w, t, p));
  px.ndv = __ldg(in.ndv + offset_of(in.ndv_p, in.tx, in.w, t, p));
  px.mask = __ldg(in.mask + offset_of(in.mask_p, in.tx, in.w, t, p)) != 0;
  const float lvl = clamp_max(clamp_min(__fmul_rn(px.rough, kMipLevels), 0.0f),
                              (float)(gr.env_mips - 1));
  px.lo = (int)floorf(lvl);
  px.hi = min(px.lo + 1, gr.env_mips - 1);
  px.lo3 = min(px.lo + 3, gr.env_mips - 1);
  return px;
}

struct Tap {
  int tex, mip;
  float u, v;
  bool act;
};

// group g of the pixel: env lo, env hi, BRDF LUT, sky, env mip+3
__device__ __forceinline__ Tap tap_of(const Groups& gr, const Pixel& px, int g) {
  switch (g) {
    case 0: return {gr.env_base + px.e.face, px.lo, px.e.u, px.e.v, px.mask};
    case 1: return {gr.env_base + px.e.face, px.hi, px.e.u, px.e.v, px.mask};
    case 2: return {gr.lut_tid, 0, px.rough, px.ndv, px.mask};
    case 3: return {gr.sky_base + px.s.face, 0, px.s.u, px.s.v, !px.mask};
    default: return {gr.env_base + px.e.face, px.lo3, px.e.u, px.e.v, px.mask};
  }
}

struct Addr {
  int page, intra;
  float fx, fy;
};

// envcache._tap_addresses_clamp: x0 = min(max(floor(u w - 0.5), 0), w - 1),
// fx = clamp(x - x0, 0, 1), 16x8-texel pages
__device__ __forceinline__ Addr address(int base_w, int base_h, int page_base, int mip, float u,
                                        float v) {
  const int w = max(base_w >> mip, 1), h = max(base_h >> mip, 1);
  const float x = __fsub_rn(__fmul_rn(u, (float)w), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, (float)h), 0.5f);
  const float x0 = clamp_max(clamp_min(floorf(x), 0.0f), (float)(w - 1));
  const float y0 = clamp_max(clamp_min(floorf(y), 0.0f), (float)(h - 1));
  Addr a;
  a.fx = clamp_max(clamp_min(__fsub_rn(x, x0), 0.0f), 1.0f);
  a.fy = clamp_max(clamp_min(__fsub_rn(y, y0), 0.0f), 1.0f);
  const int ix = (int)x0, iy = (int)y0;
  a.page = page_base + (iy >> 3) * ((w + 15) >> 4) + (ix >> 4);
  a.intra = (iy & 7) * 16 + (ix & 15);
  return a;
}

// the main tap: its mip's page base (0 for a mip outside the table)
__device__ __forceinline__ Addr main_address(const Atlas& atlas, const Tap& tp) {
  const int pb = tp.mip >= 0 && tp.mip < kMaxMips ? tab(atlas, tp.tex, 5 + tp.mip) : 0;
  return address(tab(atlas, tp.tex, 0), tab(atlas, tp.tex, 1), pb, tp.mip, tp.u, tp.v);
}

// The page plane of kernel B: one thread a pixel, every group's page and act
// at (t, g, p) of (tiles, G, npix).
__global__ void __launch_bounds__(kThreads)
    env_plan_kernel_taps(Inputs in, Groups gr, Atlas atlas, int n_px, int npix, int* pages,
                         uint8_t* act) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_px) return;
  const int t = i / npix, p = i - t * npix;
  const Pixel px = load_pixel(in, gr, t, p);
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g >= gr.g) break;
    const Tap tp = tap_of(gr, px, g);
    const size_t o = ((size_t)t * gr.g + g) * npix + p;
    pages[o] = main_address(atlas, tp).page;
    act[o] = tp.act;
  }
}

struct Select {
  Inputs in;
  Groups gr;
  Atlas atlas;
  int npix, budget, cap_max;
  const int* count;      // (tiles, G) kernel B's counts
  const int* list;       // (tiles, G, cap_max) its ascending page lists, 0-padded
  const int* slot;       // (tiles, G, npix)
  const uint8_t* found;  // (tiles, G, npix) its covered taps
  int* off;              // (tiles, G)
  int* cnts;             // (tiles, G)
  int* staged;           // (tiles, budget * 8, 128)
  int* rec;              // (tiles, G, npix)
  float* fx;
  float* fy;
  uint8_t* covered;
  int* approx;           // () the frame's fallback taps
};

// One block a tile: layout, select, staging.
__global__ void __launch_bounds__(kThreads) env_plan_kernel_select(Select s) {
  __shared__ int s_off[kMaxGroups], s_span[kMaxGroups], s_ceff[kMaxGroups];
  __shared__ int s_ids[kMaxBudget];
  __shared__ __align__(16) int s_tr[kWarps][kRecI32][kRecords + kPad];
  const int t = blockIdx.x, n_g = s.gr.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // ---- the compact layout (texcache._compact_layout), one thread ---------
  if (threadIdx.x == 0) {
    int off = 0;
    for (int g = 0; g < n_g; ++g) {
      const int cnt = s.count[t * n_g + g];
      const int want = (kCapFb + cnt + kSegChunk - 1) / kSegChunk * kSegChunk;
      const int span = min(want, s.budget - off - kSegChunk * (n_g - 1 - g));
      const int ceff = min(cnt, span - kCapFb);
      s_off[g] = off;
      s_span[g] = span;
      s_ceff[g] = ceff;
      s.off[t * n_g + g] = off;
      s.cnts[t * n_g + g] = kCapFb + ceff;
      off += span;
    }
  }
  __syncthreads();

  // ---- the staged pages' ids (texcache._pack_ids) ------------------------
  for (int j = threadIdx.x; j < s.budget; j += kThreads) {
    int id = 0;
    for (int g = 0; g < n_g; ++g) {
      const int k = j - s_off[g];
      if (k >= 0 && k < s_span[g]) {
        id = k < kCapFb ? tab(s.atlas, s.gr.fb_tid[g][k], 2)
                        : s.list[((size_t)t * n_g + g) * s.cap_max + (k - kCapFb)];
      }
    }
    s_ids[j] = id;
  }

  // ---- the taps: budget fit, shared cover of groups 0 and 1, select ------
  int approx = 0;
  for (int p = threadIdx.x; p < s.npix; p += kThreads) {
    const Pixel px = load_pixel(s.in, s.gr, t, p);
    int slot[kMaxGroups];
    bool fit[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= n_g) break;
      const size_t o = ((size_t)t * n_g + g) * s.npix + p;
      slot[g] = s.slot[o];
      fit[g] = s.found[o] && slot[g] < s_ceff[g];
    }
    const bool both = fit[0] && fit[1];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= n_g) break;
      const Tap tp = tap_of(s.gr, px, g);
      const bool cov = g < 2 ? both : fit[g];
      int rc;
      Addr a;
      if (cov) {
        a = main_address(s.atlas, tp);
        rc = (kCapFb + slot[g]) * kRecords + a.intra;
      } else {
        // the fallback: a bilinear tap on the texture's one-page coarse mip
        a = address(tab(s.atlas, tp.tex, 3), tab(s.atlas, tp.tex, 4), 0, 0, tp.u, tp.v);
        int fb_slot = 0;
        for (int j = 0; j < s.gr.fb_n[g]; ++j) {
          fb_slot = tp.tex == s.gr.fb_tid[g][j] ? j : fb_slot;
        }
        rc = fb_slot * kRecords + a.intra;
      }
      const size_t o = ((size_t)t * n_g + g) * s.npix + p;
      s.rec[o] = rc;
      s.fx[o] = a.fx;
      s.fy[o] = a.fy;
      s.covered[o] = cov;
      approx += tp.act && !cov;
    }
  }
  approx = __reduce_add_sync(0xffffffffu, approx);
  if (lane == 0 && approx) atomicAdd(s.approx, approx);
  __syncthreads();   // s_ids

  // ---- staging: a warp a page, turned through shared memory --------------
  int(*tr)[kRecords + kPad] = s_tr[warp];
  for (int j = warp; j < s.budget; j += kWarps) {
    const int4* src =
        reinterpret_cast<const int4*>(s.atlas.data + (size_t)s_ids[j] * kRecords * kRecI32);
    int4 v[kRecI32];
#pragma unroll
    for (int q = 0; q < kRecI32; ++q) v[q] = __ldg(src + lane + 32 * q);
#pragma unroll
    for (int q = 0; q < kRecI32; ++q) {   // int4 i holds words 4(i & 1).. of record i >> 1
      const int i = lane + 32 * q, r = i >> 1, k = (i & 1) * 4;
      tr[k][r] = v[q].x;
      tr[k + 1][r] = v[q].y;
      tr[k + 2][r] = v[q].z;
      tr[k + 3][r] = v[q].w;
    }
    __syncwarp();
    int4* dst =
        reinterpret_cast<int4*>(s.staged + ((size_t)t * s.budget + j) * kRecI32 * kRecords);
#pragma unroll
    for (int q = 0; q < kRecI32; ++q) {
      dst[lane + 32 * q] = *reinterpret_cast<const int4*>(&tr[q][lane * 4]);
    }
    __syncwarp();
  }
}

Inputs inputs(const float* refl, const float* ray, const float* rough, const float* ndv,
              const uint8_t* mask, const long long* pl, int tx, int w) {
  auto plane = [&](int i) {
    return Plane{pl[4 * i], pl[4 * i + 1], pl[4 * i + 2], pl[4 * i + 3]};
  };
  return Inputs{refl, ray, rough, ndv, mask, plane(0), plane(1), plane(2), plane(3), plane(4),
                pl[20], pl[21], tx, w};
}

// groups: [g, env_base, sky_base, lut_tid, env_mips, fb_n[5], fb_tid[5][8]]
bool groups_of(const int* a, Groups* gr) {
  gr->g = a[0];
  gr->env_base = a[1];
  gr->sky_base = a[2];
  gr->lut_tid = a[3];
  gr->env_mips = a[4];
  for (int g = 0; g < kMaxGroups; ++g) {
    gr->fb_n[g] = a[5 + g];
    for (int j = 0; j < kCapFb; ++j) gr->fb_tid[g][j] = a[5 + kMaxGroups + g * kCapFb + j];
  }
  return gr->g >= 2 && gr->g <= kMaxGroups && gr->env_mips >= 1;
}

}  // namespace

// `planes`: for refl, ray, roughness, n_dot_v and mask in turn the (a, b, c,
// e) of Plane, then refl's and ray's component strides; `tx`, `w` the
// layout's divisors. Both launch on `stream` and return cudaGetLastError()
// (0 = launched).
extern "C" int env_plan_taps_launch(const float* refl, const float* ray, const float* rough,
                                    const float* ndv, const uint8_t* mask, const long long* planes,
                                    int tx, int w, int tiles, int blocks, const int* table,
                                    int n_tex, const int* groups, int* pages, uint8_t* act,
                                    void* stream) {
  Groups gr;
  if (!groups_of(groups, &gr) || tiles < 0 || blocks < 1 || tx < 1 || w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_px = (long long)tiles * blocks * kRecords;
  if (n_px == 0) return 0;
  if (n_px * gr.g > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  env_plan_kernel_taps<<<(unsigned)((n_px + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(inputs(refl, ray, rough, ndv, mask, planes, tx, w), gr,
                                            Atlas{table, n_tex, nullptr}, (int)n_px,
                                            blocks * kRecords, pages, act);
  return (int)cudaGetLastError();
}

extern "C" int env_plan_select_launch(
    const float* refl, const float* ray, const float* rough, const float* ndv,
    const uint8_t* mask, const long long* planes, int tx, int w, int tiles, int blocks,
    const int* table, int n_tex, const int* groups, const int* data, const int* count,
    const int* list, int cap_max, const int* slot, const uint8_t* found, int budget, int* off,
    int* cnts, int* staged, int* rec, float* fx, float* fy, uint8_t* covered, int* approx,
    void* stream) {
  Groups gr;
  if (!groups_of(groups, &gr) || tiles < 0 || blocks < 1 || tx < 1 || w < 1 || cap_max < 1 ||
      budget < kSegChunk * gr.g || budget > kMaxBudget || budget % kSegChunk ||
      (reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(staged)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiles == 0) return 0;
  Select s{inputs(refl, ray, rough, ndv, mask, planes, tx, w), gr, Atlas{table, n_tex, data},
           blocks * kRecords, budget, cap_max, count, list, slot, found, off, cnts, staged, rec,
           fx, fy, covered, approx};
  env_plan_kernel_select<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}
