// Fused tile rasterizer + perspective-correct attribute interpolation.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/raster_pallas.py
// _kernel_interp / _kernel_interp_remap (body _kernel_interp_body): for every
// pixel of a tile, fold the tile's bin list (draw order) to the nearest
// accepted triangle, then interpolate that triangle's vertex attributes and
// emit its material row.
//
// Semantics kept exactly:
//   * the depth fold, its tie rule (strict `<` in list order) and its AABB
//     rejects are raster_fold.cuh's, shared with the depth-only kernel H;
//   * per-tile list limit: the two-pass split of the TPU kernel (small cap for
//     every tile, full cap for the hot tiles) becomes one limit per tile,
//     which the kernel derives from the bin counts.
//   * interp channel k = (lam0*a0k + lam1*a1k) + lam2*a2k with
//     lam_v = B_v / (sumB == 0 ? 1 : sumB), sumB = (B0 + B1) + B2.
//   * outputs straight into the planar layouts gbuffer_shade_planar reads:
//     tri_id (H, W) int32 (-1 background), z (H, W) (1.0 background),
//     planes (24, H, W) = interp 0-7 then material row columns 16:32,
//     all zero on background.
//
// What bounds it on an H100: its output, 26 words per pixel (24 planes, z,
// id), about 215 MB for a 1920x1080 frame, and the rows it reads (20 words
// of each listed triangle and the 40 payload words of each winner, about 38
// MB on the 1080p stress frame): bytes. The fold's arithmetic on the pairs the inputs need is far
// below that; what it costs instead is the reject work on the hot tiles' long
// lists, which raster_fold.cuh's design (per-warp AABB reject, in-order
// survivor staging with cp.async, coverage before depth, hot lists split
// across blocks) keeps short and spread over the card. Persistent blocks
// fold (tile, 8-row band, list slice) work items; once a band's winners are
// known each thread gathers its pixels' winner rows (the TPU kernel's
// one-hot MXU row select existed only to avoid in-kernel gathers and is not
// carried over) and writes 16-column row segments.
//
// Row layout (rows64, 64 floats per triangle, ops/raster_cuda.pack_rows64):
//   0:9 edge rows, 9:12 clip z, 12:15 clip w, 15 id, 16:32 material row,
//   32:56 vertex attributes (3 x [uv, normal, tangent]), 56:60 the AABB
//   (xmin, ymin, xmax, ymax), 60:64 padding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_fold.cuh"

namespace {

using raster_fold::add;
using raster_fold::dot3;
using raster_fold::kBandRows;
using raster_fold::kMaxPix;
using raster_fold::mul;

__global__ void __launch_bounds__(1024) raster_interp_kernel(
    raster_fold::Args a, int height, int* __restrict__ tri_id, float* __restrict__ zout,
    float* __restrict__ planes) {
  const size_t hw = (size_t)height * a.width;
  raster_fold::fold_tiles(a, [&](const raster_fold::Band& b, int col, float px,
                                 const float (&py)[kMaxPix], const float (&z)[kMaxPix],
                                 const int (&id)[kMaxPix]) {
    const int gx = b.tx * a.tile_w + col;
#pragma unroll
    for (int k = 0; k < kMaxPix; ++k) {
      const int row = raster_fold::pixel_row(k);
      if (row >= b.rows) continue;
      const size_t o = (size_t)(b.ty * a.tile_h + b.band * kBandRows + row) * a.width + gx;
      tri_id[o] = id[k];
      if (id[k] < 0) {
        zout[o] = 1.0f;
        for (int ch = 0; ch < 24; ++ch) planes[ch * hw + o] = 0.0f;
        continue;
      }
      zout[o] = z[k];
      const float* r = a.rows + (size_t)id[k] * 64;
      const float b0 = dot3(px, r[0], py[k], r[1], r[2]);
      const float b1 = dot3(px, r[3], py[k], r[4], r[5]);
      const float b2 = dot3(px, r[6], py[k], r[7], r[8]);
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
  });
}

}  // namespace

// Launch on `stream`; returns the CUDA error (0 = launched). keys (H * W)
// and counters (2 + num_tiles * bands) are scratch of all ones (-1), left
// all ones when the kernel ends.
extern "C" int raster_interp_launch(const float* rows64, const int* bin_ids, int cap,
                                    const int* counts, int cap_small, int hot_k,
                                    int num_tiles, int width, int height, int tile_h,
                                    int tile_w, float y_offset,
                                    unsigned long long* keys, unsigned long long* counters,
                                    int* tri_id, float* z, float* planes, void* stream) {
  const int threads = raster_fold::block_threads(tile_w);
  if (threads == 0 || num_tiles < 1 || tile_h < 1 || cap_small < 0 || hot_k < 0)
    return (int)cudaErrorInvalidValue;
  const raster_fold::Args a{rows64, 64, rows64 + 56, 64, bin_ids, cap, counts, cap_small, hot_k,
                            num_tiles, width, tile_h, tile_w, y_offset, keys, counters};
  return raster_fold::launch_persistent(raster_interp_kernel, threads, num_tiles,
                                        (cudaStream_t)stream, a, height, tri_id, z, planes);
}
