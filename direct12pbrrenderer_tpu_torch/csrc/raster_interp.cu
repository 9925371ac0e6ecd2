// Fused tile rasterizer + perspective-correct attribute interpolation.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/raster_pallas.py
// _kernel_interp / _kernel_interp_remap (body _kernel_interp_body): for every
// pixel of a tile, fold the tile's bin list (draw order) to the nearest
// accepted triangle, then interpolate that triangle's vertex attributes and
// emit its material row.
//
// Semantics kept exactly:
//   * the depth fold, its tie rule (strict `<` in list order) and the band
//     skip are raster_fold.cuh's, shared with the depth-only kernel H;
//   * per-tile list limit: the two-pass split of the TPU kernel (small cap for
//     every tile, full cap for the hot tiles) arrives as one limit per tile.
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

#include "raster_fold.cuh"

namespace {

using raster_fold::add;
using raster_fold::dot3;
using raster_fold::kBandRows;
using raster_fold::kMaxPix;
using raster_fold::mul;

__global__ void raster_interp_kernel(
    const float* __restrict__ rows64, const int* __restrict__ bin_ids, int cap,
    const int* __restrict__ limits, int width, int height, int tile_h, int tile_w,
    float y_offset, int* __restrict__ tri_id, float* __restrict__ zout,
    float* __restrict__ planes) {
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
  raster_fold::band_pixels(tile_w, ox, band_lo, px, py);
  // y-extents ride rows64 columns 56/57
  raster_fold::fold_band(rows64, 64, rows64 + 56, 64, bin_ids + (size_t)tile * cap,
                         limits[tile], band_lo, band_hi, px, py, best_z, best_id);

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
  const int threads = raster_fold::band_threads(tile_h, tile_w);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tiles, (tile_h + kBandRows - 1) / kBandRows);
  raster_interp_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      rows64, bin_ids, cap, limits, width, height, tile_h, tile_w, y_offset, tri_id, z,
      planes);
  return (int)cudaGetLastError();
}
