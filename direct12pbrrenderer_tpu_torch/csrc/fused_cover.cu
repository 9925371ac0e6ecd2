// Fused two-level page cover for the texture and env page caches, kernels B
// and I.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/texcache.py
// _fused_cover_kernel_batched (:486; _fused_cover_pallas :776 launches it
// through the pallas_call at :802; body _fused_cover_batched_body, same
// outputs as _fused_cover_kernel and _fused_cover_kernel_dyn): per (tile,
// group) of a (tiles, g, blocks, 128) page/active plane, the ascending list
// of distinct pages the tile touches, its count, and every pixel's slot in
// that list and whether it is covered.
//
// At group caps above 128 the same launch replaces the TPU's two-kernel
// cover, _block_cover_kernel (:278) + _pix_match_kernel (:331) around a
// tile-level sort (_cover_and_match_2level :837 takes them because the fused
// TPU kernel writes its list in one 128-lane row). Nothing here depends on
// the cap: shared memory holds blocks * min(block_cap, 128) candidates, and
// the cap only clamps count and slot and bounds the list's store loop.
//
// Semantics kept exactly (ops/cover_cuda.py has the plain version):
//   * row level: block_cap rounds of a min over the row's active pages not
//     yet taken; round k's min m marks the pixels whose page equals m (slot
//     k) when m is live. The mark is NOT gated by act (an inactive pixel whose
//     page equals a candidate gets a slot, never coverage). Every pixel whose
//     page equals m leaves the pool.
//   * tile level: candidate j's rank is the number of distinct candidates
//     below it, which is the ascending order of the TPU kernel's rank-matrix
//     merge. count = min(distinct, cap_g); the list holds the first count
//     distinct pages and 0 past them.
//   * pixel: slot = min(rank, cap_g - 1), covered = rank < cap_g && act; an
//     unmatched pixel gets slot 0, covered 0. An all-inactive group is all 0
//     (the TPU kernel's whole-tile gate, texcache.py:502-516).
//
// What bounds it on an H100: the per-pixel planes. Every item's act (1 byte
// a pixel) is read and its outputs (4 + 1 bytes) written, but only an item
// with an active pixel needs its pages (4 bytes): for one 1080p call with
// g = 5, about 68 MB (a texture cover) to 87 MB (the env cover), 0.020-0.026
// ms at 3.35 TB/s (chip_smoke.py prints each call's). What keeps a kernel
// from that: the texture covers' planes arrive with the group innermost
// (strides (t, 1, 128 g, g)), and a copy into a (tiles, g, blocks, 128)
// layout costs more device time than the cover itself; an item's phases
// (loads, up to block_cap dependent warp-min rounds, the merge, the stores)
// run in series, so nothing is in flight for the next item unless the
// kernel puts it there; and an O(candidates^2) merge leaves most threads
// idle. This design:
//   * reads the planes in place through their strides: no copy. Lane l of a
//     warp owns pixels l + 32 q (q < 4) of a row, so a warp's accesses are
//     as dense as the layout allows: whole 128-byte lines of a contiguous
//     plane (the env cover), one group's words at stride g of a
//     group-innermost one;
//   * persistent blocks of 256 threads, as many as fit on the card (the grid
//     is cached per device and configuration), walk the (tile, group) items;
//     a warp holds its rows (warp, warp + 8, ...) in registers and issues
//     the next item's loads into a second register set before it works on
//     the current item, so they are in flight during its rounds and merge;
//   * an item with no active pixel writes zeros and skips the rounds and the
//     merge (86.8% of the texture covers' items on the 1080p stress frame);
//     its pages are still read, because the prefetch issues them before the
//     block knows the item is empty;
//   * the rounds stay a warp min each, stopping at the row's first dead min;
//     a warp runs its rows' rounds in lockstep, their shuffles interleaved;
//   * the merge is O(L log L log rows) over the L live candidates: each row's
//     candidates are already ascending, so the rows' lists are merged
//     pairwise in log2(rows) levels (every candidate finds its place in the
//     other list by a binary search: a stable merge), first occurrences are
//     marked by comparing neighbours, the distinct pages take their ranks by
//     an exclusive block scan, and each candidate's rank is its binary search
//     in the distinct list. Written here by hand: no library sort or scan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent_grid.cuh"

constexpr int kMaxGroups = 16;

// per-group caps, passed by value (outside the anonymous namespace: the
// exported launch function takes it, and must keep external linkage)
struct Caps {
  int v[kMaxGroups];
};

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr unsigned kFull = 0xffffffffu;

// element strides of a (tiles, g, blocks, 128) plane
struct Strides {
  long long t, g, r, x;
};

struct Params {
  const int* pages;
  const uint8_t* act;
  Strides ps, as;        // of pages and act
  int n_items, g, blocks, block_cap;
  int kc;                // candidates a row can hold: min(block_cap, 128)
  int cap_max;
  Caps caps;
  int* list_out;         // (items, cap_max)
  int* cnt_out;          // (items,)
  int* slot_out;         // (items, blocks, 128), 16-byte aligned
  uint8_t* cov_out;      // (items, blocks, 128), 16-byte aligned
};

// Dynamic shared memory: cand[blocks * kc] int (row r's candidates at
// r * kc, later their ranks), then merge[2][blocks * kc] int (the merge
// levels' ping-pong buffers).
inline size_t smem_bytes(int blocks, int kc) { return (size_t)3 * blocks * kc * sizeof(int); }

// A warp's rows of one item: 4 pixels a lane per row.
struct Rows {
  int pg[kRowsPerWarp][4];
  uint32_t act[kRowsPerWarp];  // byte q: pixel q is active
};

__device__ __forceinline__ void load_rows(const Params& p, int item, int warp, int lane,
                                          Rows& out) {
  const int t = item / p.g, gi = item - t * p.g;
  const int* pb = p.pages + t * p.ps.t + gi * p.ps.g;
  const uint8_t* ab = p.act + t * p.as.t + gi * p.as.g;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + j * kWarps;
    if (r >= p.blocks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) out.pg[j][q] = kSentinel;
      out.act[j] = 0;
    } else {
      uint32_t a = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int x = lane + 32 * q;
        out.pg[j][q] = __ldg(pb + r * p.ps.r + x * p.ps.x);
        a |= (uint32_t)(__ldg(ab + r * p.as.r + x * p.as.x) != 0) << (8 * q);
      }
      out.act[j] = a;
    }
  }
}

// entries of the ascending a[0..n) below x (lower bound) or at most x (upper)
__device__ __forceinline__ int lower_bound(const int* a, int n, int x) {
  int lo = 0;
  while (n > 0) {
    const int h = n >> 1;
    if (a[lo + h] < x) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}
__device__ __forceinline__ int upper_bound(const int* a, int n, int x) {
  int lo = 0;
  while (n > 0) {
    const int h = n >> 1;
    if (a[lo + h] <= x) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

// Exclusive scan of one int per thread across the block; `total` gets the
// sum. Ends with the block synchronised (the caller syncs before reusing
// s_warp).
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_warp[w];
    base += w < warp ? t : 0;
    total += t;
  }
  return base + inc - x;
}

__global__ void __launch_bounds__(kThreads) fused_cover_kernel(Params p) {
  extern __shared__ int smem[];
  __shared__ int s_nrow[kMaxRows];       // candidates of each row
  __shared__ int s_pref[kMaxRows + 1];   // their prefix sums
  __shared__ int s_warp[kWarps];
  const int blocks = p.blocks, kc = p.kc, npix = blocks * 128;
  int* const s_cand = smem;
  int* const s_m0 = s_cand + blocks * kc;
  int* const s_m1 = s_m0 + blocks * kc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  Rows cur, nxt;
  if (blockIdx.x < p.n_items) load_rows(p, blockIdx.x, warp, lane, cur);
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    // the next item's loads stay in flight while this one is worked on
    if (item + gridDim.x < p.n_items) load_rows(p, item + gridDim.x, warp, lane, nxt);
    const size_t pix0 = (size_t)item * npix;
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) any |= cur.act[j] != 0;
    // (also the barrier after which the last item's shared arrays are free)
    if (!__syncthreads_or(any)) {
      // ---- no active pixel: all outputs 0 (the TPU kernel's gate) --------
      const int4 z = make_int4(0, 0, 0, 0);
      for (int i = threadIdx.x; i < npix / 4; i += kThreads)
        reinterpret_cast<int4*>(p.slot_out + pix0)[i] = z;
      for (int i = threadIdx.x; i < npix / 16; i += kThreads)
        reinterpret_cast<int4*>(p.cov_out + pix0)[i] = z;
      for (int i = threadIdx.x; i < p.cap_max; i += kThreads)
        p.list_out[(size_t)item * p.cap_max + i] = 0;
      if (threadIdx.x == 0) p.cnt_out[item] = 0;
      cur = nxt;
      continue;
    }

    // ---- row level: up to block_cap distinct pages of each row, ascending -
    // A warp runs the rounds of its rows in lockstep, so their warp mins are
    // in flight together; a row past `blocks` or past its first dead round
    // takes part with sentinels only.
    int v[kRowsPerWarp][4];
    uint32_t rounds[kRowsPerWarp];  // byte q: the round that marked pixel q (kc = none)
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      rounds[j] = 0x01010101u * (uint32_t)kc;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] = (cur.act[j] >> (8 * q)) & 0xffu ? cur.pg[j][q] : kSentinel;
    }
    int n_row[kRowsPerWarp] = {};
    // a row has 128 pixels: at most 128 live rounds, so a marking round is < kc
    for (int k = 0; k < p.block_cap; ++k) {
      int m[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j)
        m[j] = min(min(v[j][0], v[j][1]), min(v[j][2], v[j][3]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) m[j] = min(m[j], __shfl_xor_sync(kFull, m[j], o));
      }
      bool live = false;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        if (m[j] == kSentinel) continue;  // warp-uniform: every later round is dead too
        live = true;
        n_row[j] = k + 1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (cur.pg[j][q] == m[j]) {
            rounds[j] = (rounds[j] & ~(0xffu << (8 * q))) | ((uint32_t)k << (8 * q));
            v[j][q] = kSentinel;
          }
        }
        if (lane == 0) s_cand[(warp + j * kWarps) * kc + k] = m[j];
      }
      if (!live) break;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * kWarps;
      if (r < blocks && lane == 0) s_nrow[r] = n_row[j];
    }
    __syncthreads();
    if (warp == 0) {
      int x = lane < blocks ? s_nrow[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      s_pref[lane + 1] = x;
      if (lane == 0) s_pref[0] = 0;
    }
    __syncthreads();
    const int n_live = s_pref[blocks];

    // ---- tile level: merge the rows' ascending lists pairwise ------------
    // A segment of rows starting at row q keeps its merged list at q * kc.
    const int* src = s_cand;
    int* dst = s_m0;
    for (int s = 1; s < blocks; s <<= 1) {
      for (int idx = threadIdx.x; idx < blocks * kc; idx += kThreads) {
        const int r = idx / kc;
        const int a = r / (2 * s) * (2 * s);
        const int mid = min(a + s, blocks), end = min(a + 2 * s, blocks);
        const int len_a = s_pref[mid] - s_pref[a], len_b = s_pref[end] - s_pref[mid];
        int pos;
        if (r < mid) {
          const int i = idx - a * kc;
          if (i >= len_a) continue;
          pos = i + lower_bound(src + mid * kc, len_b, src[idx]);
        } else {
          const int i = idx - mid * kc;
          if (i >= len_b) continue;
          pos = i + upper_bound(src + a * kc, len_a, src[idx]);
        }
        dst[a * kc + pos] = src[idx];
      }
      __syncthreads();
      src = dst;
      dst = dst == s_m0 ? s_m1 : s_m0;
    }

    // first occurrences in the merged list, ranked by an exclusive scan
    int* const distinct = src == s_m0 ? s_m1 : s_m0;
    const int per = (n_live + kThreads - 1) / kThreads;
    const int lo = min(n_live, (int)threadIdx.x * per), hi = min(n_live, lo + per);
    int firsts = 0;
    for (int i = lo; i < hi; ++i) firsts += i == 0 || src[i] != src[i - 1];
    int n_distinct;
    int rank = block_exclusive_scan(firsts, s_warp, n_distinct);
    for (int i = lo; i < hi; ++i) {
      if (i == 0 || src[i] != src[i - 1]) distinct[rank++] = src[i];
    }
    __syncthreads();
    const int cap_g = p.caps.v[item % p.g];
    const int cnt_g = min(n_distinct, cap_g);
    for (int i = threadIdx.x; i < p.cap_max; i += kThreads)
      p.list_out[(size_t)item * p.cap_max + i] = i < cnt_g ? distinct[i] : 0;
    if (threadIdx.x == 0) p.cnt_out[item] = cnt_g;

    // ---- per pixel: slot and coverage through the row candidate's rank ---
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * kWarps;
      if (r >= blocks) continue;
      for (int k = lane; k < n_row[j]; k += 32) {
        s_cand[r * kc + k] = lower_bound(distinct, n_distinct, s_cand[r * kc + k]);
      }
      __syncwarp();
      int slot[4];
      uint32_t cov = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = (rounds[j] >> (8 * q)) & 0xffu;
        slot[q] = 0;
        if (k < kc) {
          const int rk = s_cand[r * kc + k];
          slot[q] = min(rk, cap_g - 1);
          cov |= (uint32_t)(rk < cap_g && ((cur.act[j] >> (8 * q)) & 0xffu)) << (8 * q);
        }
      }
      const size_t o = pix0 + (size_t)r * 128;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        p.slot_out[o + lane + 32 * q] = slot[q];
        p.cov_out[o + lane + 32 * q] = (uint8_t)((cov >> (8 * q)) & 1u);
      }
    }
    cur = nxt;
  }
}

// Launch with the persistent grid (persistent_grid.cuh), at most one block
// per item.
int launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = smem_bytes(prm.blocks, prm.kc);
  int grid = 0;
  const int e = persistent::grid(fused_cover_kernel, kThreads, smem, &grid);
  if (e != 0) return e;
  if (grid > prm.n_items) grid = prm.n_items;
  fused_cover_kernel<<<grid, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). `ps` and
// `as` are the element strides (tile, group, row, pixel) of pages and act;
// the outputs are contiguous (tiles, g, blocks, 128) (and (tiles, g,
// cap_max), (tiles, g)).
extern "C" int fused_cover_launch(const int* pages, const long long* ps, const uint8_t* act,
                                  const long long* as, int tiles, int g, int blocks,
                                  int block_cap, int cap_max, Caps caps, int* list_out,
                                  int* cnt_out, int* slot_out, uint8_t* cov_out, void* stream) {
  if (tiles < 0 || g < 1 || g > kMaxGroups || blocks < 1 || blocks > kMaxRows ||
      block_cap < 1 || cap_max < 1 ||
      (reinterpret_cast<uintptr_t>(slot_out) | reinterpret_cast<uintptr_t>(cov_out)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_items = (long long)tiles * g;
  if (n_items == 0) return 0;
  if (n_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params prm{pages, act, {ps[0], ps[1], ps[2], ps[3]}, {as[0], as[1], as[2], as[3]},
             (int)n_items, g, blocks, block_cap, block_cap < 128 ? block_cap : 128, cap_max,
             caps, list_out, cnt_out, slot_out, cov_out};
  return launch(prm, (cudaStream_t)stream);
}
