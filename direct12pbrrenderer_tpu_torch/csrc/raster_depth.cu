// Depth-only tile rasterizer.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/raster_pallas.py
// _kernel / _kernel_remap (body _kernel_body, caller rasterize_pallas): for
// every pixel of a tile, fold the tile's bin list (draw order) to the nearest
// accepted triangle and write its id and depth.
//
// Semantics kept exactly (ops/raster_cuda.py has the plain version):
//   * the depth fold, its tie rule (strict `<` in list order) and the band
//     skip are raster_fold.cuh's, shared with kernel A (raster_interp.cu);
//   * the two passes of the TPU kernel (every tile folds its first cap_small
//     entries, the hot_k fullest tiles their full list) arrive as one list
//     limit per tile, so one launch covers both;
//   * outputs straight into the image layouts raster.rasterize returns:
//     tri_id (H, W) int32 (-1 background), z (H, W) (1.0 background).
//
// What bounds it on an H100: at the typical few candidates per tile it is
// its output, 2 words per pixel (about 16.6 MB for a 1920x1080 frame); hot
// tiles with thousands of candidates are bound by the candidate loop, about
// 23 flops per pixel and candidate. Design: kernel A's, without the winner's
// row gather and interpolation — one block per (tile, 8-row band), 4 pixels a
// thread in registers, 128 candidates' raster columns staged in shared memory
// (a broadcast read), chunks that miss the band skipped with one block vote.
//
// Inputs: rows (T, 16) from pack_raster_rows (columns 0:15 read), yext (T, 2)
// the conservative screen ymin/ymax (never meeting a band for an invalid
// triangle), the bin lists (tiles, cap) and the per-tile limits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_fold.cuh"

namespace {

using raster_fold::kBandRows;
using raster_fold::kMaxPix;

__global__ void raster_depth_kernel(const float* __restrict__ rows,
                                    const float* __restrict__ yext,
                                    const int* __restrict__ bin_ids, int cap,
                                    const int* __restrict__ limits, int width, int tile_h,
                                    int tile_w, float y_offset, int* __restrict__ tri_id,
                                    float* __restrict__ zout) {
  const int tile = blockIdx.x;
  const int band = blockIdx.y;
  const int tiles_x = width / tile_w;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int rows_in_band = min(kBandRows, tile_h - band * kBandRows);  // last may be short
  const int pb = rows_in_band * tile_w;
  const float ox = (float)(tx * tile_w);
  const float oy = (float)(ty * tile_h) + y_offset;
  const float band_lo = oy + (float)(band * kBandRows);
  const float band_hi = band_lo + (float)rows_in_band;

  float px[kMaxPix], py[kMaxPix], best_z[kMaxPix];
  int best_id[kMaxPix];
  raster_fold::band_pixels(tile_w, ox, band_lo, px, py);
  raster_fold::fold_band(rows, 16, yext, 2, bin_ids + (size_t)tile * cap, limits[tile],
                         band_lo, band_hi, px, py, best_z, best_id);

#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    if (p >= pb) continue;
    const int gy = ty * tile_h + band * kBandRows + p / tile_w;
    const int gx = tx * tile_w + p % tile_w;
    const size_t o = (size_t)gy * width + gx;
    tri_id[o] = best_id[k];
    zout[o] = best_id[k] < 0 ? 1.0f : best_z[k];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int raster_depth_launch(const float* rows, const float* yext, const int* bin_ids,
                                   int cap, const int* limits, int num_tiles, int width,
                                   int tile_h, int tile_w, float y_offset, int* tri_id,
                                   float* z, void* stream) {
  const int threads = raster_fold::band_threads(tile_h, tile_w);
  if (threads == 0 || num_tiles < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tiles, (tile_h + kBandRows - 1) / kBandRows);
  raster_depth_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      rows, yext, bin_ids, cap, limits, width, tile_h, tile_w, y_offset, tri_id, z);
  return (int)cudaGetLastError();
}
