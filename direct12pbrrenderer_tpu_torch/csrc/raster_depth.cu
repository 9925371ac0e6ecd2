// Depth-only tile rasterizer.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/raster_pallas.py
// _kernel / _kernel_remap (body _kernel_body, caller rasterize_pallas): for
// every pixel of a tile, fold the tile's bin list (draw order) to the nearest
// accepted triangle and write its id and depth.
//
// Semantics kept exactly (ops/raster_cuda.py has the plain version):
//   * the depth fold, its tie rule (strict `<` in list order) and its AABB
//     rejects are raster_fold.cuh's, shared with kernel A (raster_interp.cu);
//   * the two passes of the TPU kernel (every tile folds its first cap_small
//     entries, the hot_k fullest tiles their full list) become one list
//     limit per tile, which the kernel derives from the bin counts, so one
//     launch covers both;
//   * outputs straight into the image layouts raster.rasterize returns:
//     tri_id (H, W) int32 (-1 background), z (H, W) (1.0 background).
//
// What bounds it on an H100: bytes — its output, 2 words per pixel (about
// 16.6 MB for a 1920x1080 frame), and the rows and AABBs of the listed
// triangles it reads (about 14 MB on the 1080p stress frame); the fold's
// arithmetic on the pairs the inputs need is far below. The hot tiles' long
// lists cost reject work instead, which raster_fold.cuh's design (per-warp
// AABB reject, in-order survivor staging with cp.async, coverage before
// depth, hot lists split across blocks) keeps short and spread over the
// card. Kernel A's design without the winner's row gather and
// interpolation: persistent blocks fold (tile, 8-row band, list slice) work
// items, one warp per 16x8 pixel rectangle.
//
// Inputs: rows (T, 20) from raster_cuda.pack_depth_rows: the raster columns
// 0:15 and, at 16:20, the conservative screen AABB (xmin, ymin, xmax, ymax;
// -3e38 for an invalid triangle, so it meets no rectangle); the bin lists
// (tiles, cap) and their counts (tiles,).

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_fold.cuh"

namespace {

using raster_fold::kBandRows;
using raster_fold::kMaxPix;

__global__ void __launch_bounds__(1024) raster_depth_kernel(raster_fold::Args a,
                                                            int* __restrict__ tri_id,
                                                            float* __restrict__ zout) {
  raster_fold::fold_tiles(a, [&](const raster_fold::Band& b, int col, float,
                                 const float (&)[kMaxPix], const float (&z)[kMaxPix],
                                 const int (&id)[kMaxPix]) {
    const int gx = b.tx * a.tile_w + col;
#pragma unroll
    for (int k = 0; k < kMaxPix; ++k) {
      const int row = raster_fold::pixel_row(k);
      if (row >= b.rows) continue;
      const size_t o = (size_t)(b.ty * a.tile_h + b.band * kBandRows + row) * a.width + gx;
      tri_id[o] = id[k];
      zout[o] = id[k] < 0 ? 1.0f : z[k];
    }
  });
}

}  // namespace

// Launch on `stream`; returns the CUDA error (0 = launched). keys (H * W)
// and counters (2 + num_tiles * bands) are scratch of all ones (-1), left
// all ones when the kernel ends.
extern "C" int raster_depth_launch(const float* rows, const int* bin_ids, int cap,
                                   const int* counts, int cap_small, int hot_k,
                                   int num_tiles, int width, int tile_h, int tile_w,
                                   float y_offset,
                                   unsigned long long* keys, unsigned long long* counters,
                                   int* tri_id, float* z, void* stream) {
  const int threads = raster_fold::block_threads(tile_w);
  if (threads == 0 || num_tiles < 1 || tile_h < 1 || cap_small < 0 || hot_k < 0)
    return (int)cudaErrorInvalidValue;
  const raster_fold::Args a{rows, 20, rows + 16, 20, bin_ids, cap, counts, cap_small, hot_k,
                            num_tiles, width, tile_h, tile_w, y_offset, keys, counters};
  return raster_fold::launch_persistent(raster_depth_kernel, threads, num_tiles,
                                        (cudaStream_t)stream, a, tri_id, z);
}
