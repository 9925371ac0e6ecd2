// The tile rasterizer's depth fold, shared by kernel A (raster_interp.cu) and
// the depth-only kernel H (raster_depth.cu), so both keep one tie rule.
//
// Semantics (the TPU kernels' _kernel_body / _kernel_interp_body):
//   * edge scores s_i = (px*e_i0 + py*e_i1) + e_i2; den = (s0 w0 + s1 w1) + s2 w2;
//     zc = ((s0 z0 + s1 z1) + s2 z2) / den; accepted when all s_i >= 0,
//     den > 0 and 0 <= zc <= 1 (the D3D clip planes per pixel). Every product
//     and sum is rounded separately (__fmul_rn/__fadd_rn, and the kernels are
//     built with --fmad=false): coverage at exact edges must not depend on
//     multiply-add contraction.
//   * winner: the earliest list entry among equal minimal zc (a strict `<` in
//     list order, so -0.0 and +0.0 tie) — the TPU kernel's argmin-first
//     within a chunk and strict `<` across chunks.
//
// What bounds it on an H100: the fold's own arithmetic is small. A pixel
// covered by a candidate lies inside the candidate's conservative integer
// screen AABB (the premise binning already rests on), and on the 1080p
// stress frame under 1% of the (pixel, listed candidate) pairs do; the rest
// is reject work. The hot tiles list thousands of candidates against a mean
// of about 300, so without care the longest bands set the pace. Tensor cores
// do not apply: acceptance at exact edges, the tie rule and bit-equality with
// the plain version need every product and sum rounded on its own in
// float32, which TF32 or bf16 wgmma cannot give. The design:
//   1. Per-warp AABB reject. A block folds one 8-row band of a tile; every
//      warp owns a 16-column x 8-row pixel rectangle (4 pixels a thread: one
//      column, rows lane/16 + 2k) and tests each candidate's AABB against it,
//      32 candidates per ballot, before any per-pixel arithmetic: the branch
//      is warp-uniform and the fold runs only for the candidates that meet
//      the rectangle.
//   2. In-order survivor staging. The list is walked in chunks of 128
//      entries. Per chunk the block reads ids and AABBs, keeps the entries
//      whose AABB meets the band (a ballot and a prefix count per 32
//      entries: a stable compaction, so survivors stay in list order) and
//      copies only the survivors' 16 raster floats into shared memory with
//      cp.async, each with its list position. Two stage buffers: chunk c+1's
//      copies and chunk c+2's AABB loads are in flight while the warps fold
//      chunk c, one __syncthreads per chunk.
//   3. Coverage before depth: den, num and the division run only where all
//      three edge scores are >= 0 (and the division only where den > 0).
//      The rounding steps are the same, so winners and zc stay bit-equal.
//   4. Hot lists split across blocks. A band's list is cut into slices of
//      kSlice entries; one block folds one (tile, band, slice) work item,
//      taken from an atomic queue by persistent blocks (each block derives
//      the list limits and the items per tile from the bin counts: no host
//      sync, no launch before the kernel's). A band of one
//      slice writes its pixels directly. The slices of a longer band merge
//      per pixel into a 64-bit key, (bits(zc) with -0.0 as +0.0) << 32 |
//      list position, with atomicMin: the smallest key is the smallest
//      depth, then the earliest entry — the strict `<` in list order, ties
//      of -0.0 and +0.0 included. The band's last slice to finish (a
//      counter per band) reads the keys back, recomputes each winner's zc
//      with the same rounded arithmetic (so z is bit-equal, -0.0 included)
//      and writes the band.
// The scratch (keys and counters) is all ones at launch and all ones again
// when the kernel ends: the last slice of a band resets its keys and its
// counter, the last block to leave resets the queue. So the wrapper keeps
// one scratch per device and stream and fills it once.
// The AABB tests use binning's comparison (ops/raster.py bin_triangles):
// xmin < x1 && xmax > x0 && ymin < y1 && ymax > y0 in pixel-edge
// coordinates; invalid triangles carry an AABB of -3e38 and meet nothing.
//
// Inputs per triangle id, in 16-byte aligned rows (ops/raster_cuda.pack_rows64
// for kernel A, pack_depth_rows for H): raster columns 0:9 edge rows, 9:12
// clip z, 12:15 clip w, 15 not read (copied with the rest); the AABB as one
// float4 [xmin, ymin, xmax, ymax].

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "persistent_grid.cuh"

namespace raster_fold {

constexpr int kChunk = 128;          // list entries staged per step
constexpr int kBandRows = 8;         // pixel rows per band
constexpr int kWarpCols = 16;        // a warp's pixel rectangle: 16 columns x 8 rows
constexpr int kMaxPix = 4;           // pixels per thread
constexpr int kGroups = kChunk / 32;
constexpr int kSlice = 4 * kChunk;   // list entries one work item folds at most

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// (a*b + c*d) + e, each step rounded
__device__ __forceinline__ float dot3(float a, float b, float c, float d, float e) {
  return add(add(mul(a, b), mul(c, d)), e);
}

// Threads per block for tile_w columns: one warp per 16 columns, and at least
// the 4 warps that stage a chunk; 0 when the tile is wider than 32 warps.
inline int block_threads(int tile_w) {
  const int warps = (tile_w + kWarpCols - 1) / kWarpCols;
  if (tile_w < 1 || warps > 32) return 0;
  return 32 * (warps < kGroups ? kGroups : warps);
}

// This thread's pixel row k (of 4) within its band.
__device__ __forceinline__ int pixel_row(int k) { return ((threadIdx.x & 31) >> 4) + 2 * k; }

// What a launch hands the fold.
struct Args {
  const float* rows;  // raster columns of triangle id at rows + id * row_stride
  int row_stride;
  const float* ext;   // AABB of triangle id at ext + id * ext_stride
  int ext_stride;
  const int* bin_ids;  // (num_tiles, cap) bin lists
  int cap;
  const int* counts;   // (num_tiles,) bin counts (above cap on overflow)
  int cap_small, hot_k;  // the two-pass list limits (fold_tiles)
  int num_tiles, width, tile_h, tile_w;
  float y_offset;
  unsigned long long* keys;  // (H * W) merge keys of split bands, all ones at launch
  unsigned long long* counters;  // [0] work queue, [1] blocks done, [2 + tile * bands +
                                 // band] slices done; all ones at launch
};

// One work item's band: pixels [ox, ox + tile_w) x [lo, hi) of tile (tx, ty).
struct Band {
  int tile, band, tx, ty, rows;
  float ox, lo, hi;
};

// Binning's overlap test of an AABB e = (xmin, ymin, xmax, ymax) with the
// rectangle [x0, x1) x [y0, y1).
__device__ __forceinline__ bool meets(float4 e, float x0, float x1, float y0, float y1) {
  return e.x < x1 && e.z > x0 && e.y < y1 && e.w > y0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One chunk's survivors, in list order.
struct Stage {
  float4 row[kChunk][4];  // raster columns 0:16
  float4 ext[kChunk];     // AABB (xmin, ymin, xmax, ymax)
  int pos[kChunk];        // position in the tile's list
};

// zc of one candidate at one pixel, rounded as the fold rounds it (for a
// winner: den > 0).
__device__ __forceinline__ float depth_at(const float* r, float px, float py) {
  const float s0 = dot3(px, r[0], py, r[1], r[2]);
  const float s1 = dot3(px, r[3], py, r[4], r[5]);
  const float s2 = dot3(px, r[6], py, r[7], r[8]);
  const float den = add(add(mul(s0, r[12]), mul(s1, r[13])), mul(s2, r[14]));
  const float num = add(add(mul(s0, r[9]), mul(s1, r[10])), mul(s2, r[11]));
  return __fdiv_rn(num, den);
}

// Fold one survivor into this thread's pixels (step 3: coverage first).
__device__ __forceinline__ void fold_one(const float4 (&row)[4], int pos, float px,
                                         const float (&py)[kMaxPix],
                                         float (&best_z)[kMaxPix], int (&best_pos)[kMaxPix]) {
  // row: e00 e01 e02 e10 | e11 e12 e20 e21 | e22 z0 z1 z2 | w0 w1 w2 id
  const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3];
  const float a0 = mul(px, r0.x), a1 = mul(px, r0.w), a2 = mul(px, r1.z);
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    const float s0 = add(add(a0, mul(py[k], r0.y)), r0.z);
    const float s1 = add(add(a1, mul(py[k], r1.x)), r1.y);
    const float s2 = add(add(a2, mul(py[k], r1.w)), r2.x);
    // explicit comparisons: a NaN score fails them (jnp.minimum would
    // propagate it; fminf would drop it)
    if (s0 >= 0.0f && s1 >= 0.0f && s2 >= 0.0f) {
      const float den = add(add(mul(s0, r3.x), mul(s1, r3.y)), mul(s2, r3.z));
      if (den > 0.0f) {
        const float num = add(add(mul(s0, r2.y), mul(s1, r2.z)), mul(s2, r2.w));
        const float zc = __fdiv_rn(num, den);
        if (zc >= 0.0f && zc <= 1.0f && zc < best_z[k]) {
          best_z[k] = zc;
          best_pos[k] = pos;
        }
      }
    }
  }
}

// Fold list entries [pos0, pos0 + n) of a tile's bin list `ids` into each
// thread's pixels' (best_z, best_pos) over the band b; best_z starts at +inf
// and best_pos at -1. px / py are the thread's pixel centers. Every thread of
// the block must call it (it synchronizes).
__device__ __forceinline__ void fold_band(const Args& a, const int* __restrict__ ids,
                                          int pos0, int n, const Band& b, float px,
                                          const float (&py)[kMaxPix],
                                          float (&best_z)[kMaxPix], int (&best_pos)[kMaxPix]) {
  __shared__ Stage s_stage[2];
  __shared__ int s_group[3][kGroups];  // survivors per 32 entries, chunk c in slot c % 3
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    best_z[k] = __int_as_float(0x7f800000);  // +inf
    best_pos[k] = -1;
  }
  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks == 0) return;  // block-uniform

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stager = warp < kGroups;  // thread tid stages entry tid of each chunk
  const float bx1 = b.ox + (float)a.tile_w;
  const bool has_px = warp * kWarpCols < a.tile_w;  // padding warps own no pixel
  const float wx0 = b.ox + (float)(warp * kWarpCols);
  const float wx1 = b.ox + (float)min(warp * kWarpCols + kWarpCols, a.tile_w);

  auto load_id = [&](int c) {
    const int j = c * kChunk + tid;
    return stager && j < n ? ids[pos0 + j] : -1;
  };
  auto load_ext = [&](int id) {
    return id >= 0 ? *reinterpret_cast<const float4*>(a.ext + (size_t)id * a.ext_stride)
                   : make_float4(-3e38f, -3e38f, -3e38f, -3e38f);
  };
  // entry tid of chunk c meets the band: ballot, count per 32 entries, rank
  auto flag = [&](int c, int id, float4 e, int& rank) {
    const bool hit = id >= 0 && meets(e, b.ox, bx1, b.lo, b.hi);
    if (stager) {
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      rank = __popc(m & ((1u << lane) - 1u));
      if (lane == 0) s_group[c % 3][warp] = __popc(m);
    }
    return hit;
  };
  // copy entry tid of chunk c (a survivor) to its slot in stage buffer c & 1
  auto scatter = [&](int c, int id, float4 e, int rank) {
    int off = rank;
    for (int g = 0; g < warp; ++g) off += s_group[c % 3][g];
    Stage& st = s_stage[c & 1];
    st.pos[off] = pos0 + c * kChunk + tid;
    st.ext[off] = e;
    const float* r = a.rows + (size_t)id * a.row_stride;
#pragma unroll
    for (int q = 0; q < 4; ++q) cp_async16(&st.row[off][q], r + 4 * q);
  };

  // prologue: chunk 0 staged, chunk 1 flagged, chunk 2's ids loaded
  int id1 = load_id(0), rank1 = 0;
  float4 e1 = load_ext(id1);
  int id2 = load_id(1);
  bool hit1 = flag(0, id1, e1, rank1);
  __syncthreads();
  if (hit1) scatter(0, id1, e1, rank1);
  cp_async_commit();
  e1 = load_ext(id2);
  id1 = id2;
  id2 = load_id(2);
  hit1 = flag(1, id1, e1, rank1);

  for (int c = 0; c < n_chunks; ++c) {
    // chunk c's copies have landed; chunk c+1's counts are visible; every
    // warp is done with chunk c-1 (stage buffer (c+1) & 1 is free)
    cp_async_wait_all();
    __syncthreads();
    if (hit1) scatter(c + 1, id1, e1, rank1);
    cp_async_commit();
    const float4 e2 = load_ext(id2);  // chunk c+2, in flight during the fold
    const int id3 = load_id(c + 3);

    if (has_px) {  // warp-uniform
      const Stage& st = s_stage[c & 1];
      int m_all = 0;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) m_all += s_group[c % 3][g];
      for (int j0 = 0; j0 < m_all; j0 += 32) {
        const int j = j0 + lane;
        unsigned m = __ballot_sync(0xffffffffu,
                                   j < m_all && meets(st.ext[j], wx0, wx1, b.lo, b.hi));
        while (m) {  // this warp's candidates, in list order
          const int jj = j0 + __ffs(m) - 1;
          m &= m - 1u;
          fold_one(st.row[jj], st.pos[jj], px, py, best_z, best_pos);
        }
      }
    }

    hit1 = flag(c + 2, id2, e2, rank1);
    e1 = e2;
    id1 = id2;
    id2 = id3;
  }
}

// The persistent loop: each block takes (tile, band, slice) work items from
// the queue until none is left, folds the slice and hands every pixel's
// (z, winner id or -1) to write(band, col, px, py, z, id) — once per band,
// by the band's only slice or, for a split band, by its last slice after the
// key merge. Needs 3 * num_tiles + 1 ints of dynamic shared memory.
template <class Write>
__device__ __forceinline__ void fold_tiles(const Args& a, Write write) {
  extern __shared__ int s_start[];  // first work item of each tile, then the total
  int* s_limit = s_start + a.num_tiles + 1;  // entries of each tile's list to fold
  int* s_over = s_limit + a.num_tiles;       // the tiles above cap_small
  __shared__ int s_item, s_last, s_n_over;
  const int bands = (a.tile_h + kBandRows - 1) / kBandRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto slices = [&](int limit) {
    return limit > kSlice ? (limit + kSlice - 1) / kSlice : 1;
  };

  // The TPU kernel's two-pass limits: every tile folds its first cap_small
  // entries, the hot_k fullest tiles (by clamped count, ties to the lower
  // tile index, as lax.top_k and raster_cuda.tile_limits) their whole list.
  // Only the tiles above cap_small are ranked, and only among themselves
  // (no other tile ranks before one of them), one warp per tile.
  if (tid == 0) s_n_over = 0;
  __syncthreads();
  for (int t = tid; t < a.num_tiles; t += blockDim.x) {
    const int c = min(a.counts[t], a.cap);
    s_limit[t] = c;
    s_start[t + 1] = min(c, a.cap_small);  // the limit, until a hot tile's is known
    if (c > a.cap_small && a.hot_k > 0) s_over[atomicAdd(&s_n_over, 1)] = t;
  }
  __syncthreads();
  const int n_over = s_n_over;
  if (n_over <= a.hot_k) {  // every tile above cap_small is hot
    for (int i = tid; i < n_over; i += blockDim.x) s_start[s_over[i] + 1] = s_limit[s_over[i]];
  } else {
    for (int i = warp; i < n_over; i += blockDim.x >> 5) {  // warp-uniform
      const int t = s_over[i], c = s_limit[t];
      int rank = 0;
      for (int j = lane; j < n_over; j += 32) {
        const int u = s_over[j], cu = s_limit[u];
        rank += cu > c || (cu == c && u < t);
      }
      rank = __reduce_add_sync(0xffffffffu, rank);
      if (lane == 0 && rank < a.hot_k) s_start[t + 1] = c;
    }
  }
  __syncthreads();
  // work items per tile (bands x slices), then their exclusive prefix
  for (int t = tid; t < a.num_tiles; t += blockDim.x) {
    s_limit[t] = s_start[t + 1];
    s_start[t + 1] = bands * slices(s_limit[t]);
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int t0 = 0; t0 < a.num_tiles; t0 += 32) {
      int v = t0 + lane < a.num_tiles ? s_start[t0 + lane + 1] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      if (t0 + lane < a.num_tiles) s_start[t0 + lane + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) s_start[0] = 0;
  }

  const int col = warp * kWarpCols + (lane & 15);
  for (;;) {
    __syncthreads();  // s_start ready; every thread is done with the last item
    if (tid == 0) s_item = (int)(atomicAdd(&a.counters[0], 1ull) + 1ull);
    __syncthreads();
    const int item = s_item;
    if (item >= s_start[a.num_tiles]) {  // block-uniform
      if (tid == 0) {  // the last block to leave resets the queue for the next launch
        __threadfence();
        if (atomicAdd(&a.counters[1], 1ull) + 1ull == (unsigned long long)(gridDim.x - 1)) {
          __threadfence();
          a.counters[0] = ~0ull;
          a.counters[1] = ~0ull;
        }
      }
      return;
    }

    int lo = 0, hi = a.num_tiles;  // the tile: s_start[tile] <= item < s_start[tile + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_start[mid] <= item) lo = mid; else hi = mid;
    }
    const int tile = lo, local = item - s_start[tile];
    const int limit = s_limit[tile], n_slices = slices(limit);
    const int slice = local / bands;
    Band b;
    b.tile = tile;
    b.band = local % bands;
    b.tx = tile % (a.width / a.tile_w);
    b.ty = tile / (a.width / a.tile_w);
    b.rows = min(kBandRows, a.tile_h - b.band * kBandRows);  // the last band may be short
    b.ox = (float)(b.tx * a.tile_w);
    b.lo = (float)(b.ty * a.tile_h) + a.y_offset + (float)(b.band * kBandRows);
    b.hi = b.lo + (float)b.rows;

    const float px = (float)col + 0.5f + b.ox;
    float py[kMaxPix], z[kMaxPix];
    int pos[kMaxPix], id[kMaxPix];
#pragma unroll
    for (int k = 0; k < kMaxPix; ++k) py[k] = (float)pixel_row(k) + 0.5f + b.lo;
    const int* ids = a.bin_ids + (size_t)tile * a.cap;
    const int first = slice * kSlice;
    fold_band(a, ids, first, min(kSlice, limit - first), b, px, py, z, pos);

    const bool own = col < a.tile_w;
    const size_t row0 = (size_t)(b.ty * a.tile_h + b.band * kBandRows) * a.width;
    const int gx = b.tx * a.tile_w + col;
    if (n_slices > 1) {  // merge into the keys; the band's last slice writes it
#pragma unroll
      for (int k = 0; k < kMaxPix; ++k) {
        const int r = pixel_row(k);
        if (own && r < b.rows && pos[k] >= 0) {
          const unsigned long long key =
              (unsigned long long)(__float_as_uint(z[k]) & 0x7fffffffu) << 32 |
              (unsigned)pos[k];
          atomicMin(&a.keys[row0 + (size_t)r * a.width + gx], key);
        }
      }
      __threadfence();
      __syncthreads();
      unsigned long long* done = &a.counters[2 + tile * bands + b.band];
      if (tid == 0) {
        s_last = atomicAdd(done, 1ull) + 1ull == (unsigned long long)(n_slices - 1);
        if (s_last) *done = ~0ull;  // every slice has counted: reset for the next launch
      }
      __syncthreads();
      if (!s_last) continue;  // block-uniform
      __threadfence();
#pragma unroll
      for (int k = 0; k < kMaxPix; ++k) {
        const int r = pixel_row(k);
        pos[k] = -1;
        if (own && r < b.rows) {
          unsigned long long* key = &a.keys[row0 + (size_t)r * a.width + gx];
          const unsigned long long v = __ldcg(key);
          if (v != ~0ull) {
            pos[k] = (int)(unsigned)v;
            *key = ~0ull;  // reset for the next launch
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPix; ++k) {
      id[k] = pos[k] >= 0 ? ids[pos[k]] : -1;
      if (n_slices > 1 && id[k] >= 0)
        z[k] = depth_at(a.rows + (size_t)id[k] * a.row_stride, px, py[k]);
    }
    if (own) write(b, col, px, py, z, id);
  }
}

// Launch `kernel` (a fold_tiles loop) with the persistent grid
// (persistent_grid.cuh) and the dynamic shared memory of the tiles' limits
// and work prefix. Returns the CUDA error (0 = launched).
template <class Kernel, class... Params>
inline int launch_persistent(Kernel kernel, int threads, int num_tiles, cudaStream_t stream,
                             Params... params) {
  const size_t smem = (size_t)(3 * num_tiles + 1) * sizeof(int);
  int blocks = 0;
  const int e = persistent::grid(kernel, threads, smem, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, threads, smem, stream>>>(params...);
  return (int)cudaGetLastError();
}

}  // namespace raster_fold
