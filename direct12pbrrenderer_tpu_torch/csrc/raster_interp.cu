// Fused tile rasterizer + perspective-correct attribute interpolation.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/raster_pallas.py
// _kernel_interp / _kernel_interp_remap (body _kernel_interp_body): for every
// pixel of a tile, fold the tile's bin list (draw order) to the nearest
// accepted triangle, then interpolate that triangle's vertex attributes and
// emit its material row.
//
// Semantics kept exactly:
//   * edge scores s_i = (px*e_i0 + py*e_i1) + e_i2; den = (s0 w0 + s1 w1) + s2 w2;
//     zc = ((s0 z0 + s1 z1) + s2 z2) / (den == 0 ? 1 : den); accepted when all
//     s_i >= 0, den > 0 and 0 <= zc <= 1 (the D3D clip planes per pixel).
//     Every product and sum is rounded separately (__fmul_rn/__fadd_rn, and
//     the file is built with --fmad=false): coverage at exact edges must not
//     depend on multiply-add contraction.
//   * winner: the earliest list entry among equal minimal zc (a strict `<`
//     in list order) — the TPU kernel's argmin-first within a chunk and strict
//     `<` across chunks.
//   * per-tile list limit: the two-pass split of the TPU kernel (small cap for
//     every tile, full cap for the hot tiles) arrives as one limit per tile.
//   * chunks of 128 candidates; a chunk whose candidates' y-extents all miss
//     the block's band of up to 8 rows is skipped. The y-extents are the
//     conservative screen AABB, so a skipped chunk covers no pixel of the
//     band and the skip never changes a result (the plain version, which
//     skips nothing, agrees bit for bit).
//   * interp channel k = (lam0*a0k + lam1*a1k) + lam2*a2k with
//     lam_v = B_v / (sumB == 0 ? 1 : sumB), sumB = (B0 + B1) + B2.
//   * outputs straight into the planar layouts gbuffer_shade_planar reads:
//     tri_id (H, W) int32 (-1 background), z (H, W) (1.0 background),
//     planes (24, H, W) = interp 0-7 then material row columns 16:32,
//     all zero on background.
//
// What bounds it on an H100: at the typical few candidates per tile the
// kernel is bound by its output, 26 words per pixel (24 planes, z, id):
// about 215 MB for a 1920x1080 frame, written once, coalesced along rows.
// Hot tiles (thousands of candidates) are bound by the candidate loop, about
// 20 flops per pixel and candidate. Design: one block per (tile, 8-row band)
// keeps the pixels' best depth and winner id in registers (4 pixels a
// thread), stages 128 candidates' raster columns in shared memory (every
// thread then reads the same candidate: a broadcast), skips chunks that miss
// the band with one block-wide vote, and gathers the winner's 64-float row
// once per pixel after the fold — the TPU kernel's one-hot MXU row select
// existed only to avoid in-kernel gathers and is not carried over.
//
// Row layout (rows64, 64 floats per triangle, ops/raster_cuda.pack_rows64):
//   0:9 edge rows, 9:12 clip z, 12:15 clip w, 15 id, 16:32 material row,
//   32:56 vertex attributes (3 x [uv, normal, tangent]), 56/57 y-extents.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void raster_interp_kernel(
    const float* __restrict__ rows64, const int* __restrict__ bin_ids, int cap,
    const int* __restrict__ limits, int width, int height, int tile_h, int tile_w,
    float y_offset, int* __restrict__ tri_id, float* __restrict__ zout,
    float* __restrict__ planes) {
  __shared__ float s_col[kRasterCols][kChunk];
  __shared__ int s_id[kChunk];

  const int tile = blockIdx.x;
  const int band = blockIdx.y;
  const int tiles_x = width / tile_w;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int rows = min(kBandRows, tile_h - band * kBandRows);  // last band may be short
  const int pb = rows * tile_w;
  const float ox = (float)(tx * tile_w);
  const float oy = (float)(ty * tile_h) + y_offset;
  const float band_lo = oy + (float)(band * kBandRows);
  const float band_hi = band_lo + (float)rows;

  float px[kMaxPix], py[kMaxPix], best_z[kMaxPix];
  int best_id[kMaxPix];
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    // pixel centers are small integers + 0.5: exact in float32
    px[k] = (float)(p % tile_w) + 0.5f + ox;
    py[k] = (float)(p / tile_w) + 0.5f + band_lo;
    best_z[k] = __int_as_float(0x7f800000);  // +inf
    best_id[k] = -1;
  }

  const int limit = limits[tile];
  const int n_chunks = (limit + kChunk - 1) / kChunk;
  const int* ids_row = bin_ids + (size_t)tile * cap;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's readers are done with s_col
    int hit = 0;
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
      const int pos = c * kChunk + j;
      const int id = pos < limit ? ids_row[pos] : -1;
      s_id[j] = id;
      if (id >= 0) {
        const float* r = rows64 + (size_t)id * 64;
#pragma unroll
        for (int q = 0; q < kRasterCols; ++q) s_col[q][j] = r[q];
        hit |= (r[56] < band_hi) && (r[57] > band_lo);
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

  const size_t hw = (size_t)height * width;
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    if (p >= pb) continue;
    const int gy = ty * tile_h + band * kBandRows + p / tile_w;
    const int gx = tx * tile_w + p % tile_w;
    const size_t o = (size_t)gy * width + gx;
    const int id = best_id[k];
    tri_id[o] = id;
    if (id < 0) {
      zout[o] = 1.0f;
      for (int ch = 0; ch < 24; ++ch) planes[ch * hw + o] = 0.0f;
      continue;
    }
    zout[o] = best_z[k];
    const float* r = rows64 + (size_t)id * 64;
    const float b0 = dot3(px[k], r[0], py[k], r[1], r[2]);
    const float b1 = dot3(px[k], r[3], py[k], r[4], r[5]);
    const float b2 = dot3(px[k], r[6], py[k], r[7], r[8]);
    const float sum_b = add(add(b0, b1), b2);
    const float d = sum_b == 0.0f ? 1.0f : sum_b;
    const float l0 = __fdiv_rn(b0, d), l1 = __fdiv_rn(b1, d), l2 = __fdiv_rn(b2, d);
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      planes[ch * hw + o] =
          add(add(mul(l0, r[32 + ch]), mul(l1, r[40 + ch])), mul(l2, r[48 + ch]));
    }
#pragma unroll
    for (int ch = 0; ch < 16; ++ch) planes[(8 + ch) * hw + o] = r[16 + ch];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int raster_interp_launch(const float* rows64, const int* bin_ids, int cap,
                                    const int* limits, int num_tiles, int width,
                                    int height, int tile_h, int tile_w, float y_offset,
                                    int* tri_id, float* z, float* planes, void* stream) {
  const int pb = min(kBandRows, tile_h) * tile_w;
  int threads = (pb + kMaxPix - 1) / kMaxPix;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 32 || threads > 1024 || pb > threads * kMaxPix) return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tiles, (tile_h + kBandRows - 1) / kBandRows);
  raster_interp_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      rows64, bin_ids, cap, limits, width, height, tile_h, tile_w, y_offset, tri_id, z,
      planes);
  return (int)cudaGetLastError();
}
