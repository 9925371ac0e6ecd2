// The tile rasterizer's depth fold, shared by kernel A (raster_interp.cu) and
// the depth-only kernel H (raster_depth.cu), so both keep one tie rule.
//
// Semantics (the TPU kernels' _kernel_body / _kernel_interp_body):
//   * edge scores s_i = (px*e_i0 + py*e_i1) + e_i2; den = (s0 w0 + s1 w1) + s2 w2;
//     zc = ((s0 z0 + s1 z1) + s2 z2) / (den == 0 ? 1 : den); accepted when all
//     s_i >= 0, den > 0 and 0 <= zc <= 1 (the D3D clip planes per pixel).
//     Every product and sum is rounded separately (__fmul_rn/__fadd_rn, and
//     the kernels are built with --fmad=false): coverage at exact edges must
//     not depend on multiply-add contraction.
//   * winner: the earliest list entry among equal minimal zc (a strict `<` in
//     list order) — the TPU kernel's argmin-first within a chunk and strict
//     `<` across chunks.
//   * chunks of 128 candidates; a chunk whose candidates' y-extents all miss
//     the block's band of up to 8 rows is skipped. The y-extents are the
//     conservative screen AABB, so a skipped chunk covers no pixel of the band
//     and the skip never changes a result.
//
// Raster columns of a triangle row (ops/raster_cuda.pack_raster_rows): 0:9
// edge rows, 9:12 clip z, 12:15 clip w (column 15, the id, is not read: the
// bin list gives it).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace raster_fold {

constexpr int kChunk = 128;   // candidates staged per step
constexpr int kMaxPix = 4;    // pixels per thread
constexpr int kBandRows = 8;  // pixel rows per block
constexpr int kRasterCols = 15;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// (a*b + c*d) + e, each step rounded
__device__ __forceinline__ float dot3(float a, float b, float c, float d, float e) {
  return add(add(mul(a, b), mul(c, d)), e);
}

// Threads per block for a band of min(8, tile_h) rows of tile_w pixels, 4
// pixels a thread; 0 when the band does not fit one block.
inline int band_threads(int tile_h, int tile_w) {
  const int pb = (tile_h < kBandRows ? tile_h : kBandRows) * tile_w;
  int threads = (pb + kMaxPix - 1) / kMaxPix;
  threads = ((threads + 31) / 32) * 32;
  return (threads < 32 || threads > 1024 || pb > threads * kMaxPix) ? 0 : threads;
}

// One (tile, band) block's pixel centers: thread pixel k is p = threadIdx.x +
// k * blockDim.x of the band, row-major (pixel centers are small integers +
// 0.5: exact in float32).
__device__ __forceinline__ void band_pixels(int tile_w, float ox, float band_lo,
                                            float (&px)[kMaxPix], float (&py)[kMaxPix]) {
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    px[k] = (float)(p % tile_w) + 0.5f + ox;
    py[k] = (float)(p / tile_w) + 0.5f + band_lo;
  }
}

// Fold the first `limit` entries of a tile's bin list into each thread's
// pixels' (best_z, best_id); best_z starts at +inf and best_id at -1. Row
// `id` of `rows` (stride row_stride floats) holds the raster columns; its
// y-extents are yext[id * yext_stride + 0/1]. Every thread of the block
// must call it (it synchronizes).
__device__ __forceinline__ void fold_band(const float* __restrict__ rows, int row_stride,
                                          const float* __restrict__ yext, int yext_stride,
                                          const int* __restrict__ ids_row, int limit,
                                          float band_lo, float band_hi,
                                          const float (&px)[kMaxPix], const float (&py)[kMaxPix],
                                          float (&best_z)[kMaxPix], int (&best_id)[kMaxPix]) {
  __shared__ float s_col[kRasterCols][kChunk];
  __shared__ int s_id[kChunk];
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    best_z[k] = __int_as_float(0x7f800000);  // +inf
    best_id[k] = -1;
  }
  const int n_chunks = (limit + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's readers are done with s_col
    int hit = 0;
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
      const int pos = c * kChunk + j;
      const int id = pos < limit ? ids_row[pos] : -1;
      s_id[j] = id;
      if (id >= 0) {
        const float* r = rows + (size_t)id * row_stride;
#pragma unroll
        for (int q = 0; q < kRasterCols; ++q) s_col[q][j] = r[q];
        const float* y = yext + (size_t)id * yext_stride;
        hit |= (y[0] < band_hi) && (y[1] > band_lo);
      }
    }
    if (!__syncthreads_or(hit)) continue;  // no candidate meets this band

    for (int j = 0; j < kChunk; ++j) {
      const int id = s_id[j];
      if (id < 0) continue;  // padding never covers a pixel
      const float e00 = s_col[0][j], e01 = s_col[1][j], e02 = s_col[2][j];
      const float e10 = s_col[3][j], e11 = s_col[4][j], e12 = s_col[5][j];
      const float e20 = s_col[6][j], e21 = s_col[7][j], e22 = s_col[8][j];
      const float z0 = s_col[9][j], z1 = s_col[10][j], z2 = s_col[11][j];
      const float w0 = s_col[12][j], w1 = s_col[13][j], w2 = s_col[14][j];
#pragma unroll
      for (int k = 0; k < kMaxPix; ++k) {
        const float s0 = dot3(px[k], e00, py[k], e01, e02);
        const float s1 = dot3(px[k], e10, py[k], e11, e12);
        const float s2 = dot3(px[k], e20, py[k], e21, e22);
        const float den = add(add(mul(s0, w0), mul(s1, w1)), mul(s2, w2));
        const float num = add(add(mul(s0, z0), mul(s1, z1)), mul(s2, z2));
        const float zc = __fdiv_rn(num, den == 0.0f ? 1.0f : den);
        // explicit comparisons: a NaN score fails them (jnp.minimum would
        // propagate it; fminf would drop it)
        const bool ok = s0 >= 0.0f && s1 >= 0.0f && s2 >= 0.0f && den > 0.0f &&
                        zc >= 0.0f && zc <= 1.0f;
        if (ok && zc < best_z[k]) {
          best_z[k] = zc;
          best_id[k] = id;
        }
      }
    }
  }
}

}  // namespace raster_fold
