// Env-cache tap resolve for the unfused deferred pass.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/envcache.py _kernel
// (over _resolve_env_group): for every tile and each of its G tap groups,
// resolve the per-pixel clamp-quad tap against the tile's staged bf16 pages
// and blend it bilinearly. Output (tiles, G, 4, blocks, 128) f32 rgba.
//
// Semantics kept (ops/env_resolve_cuda.py has the plain version): the tap
// body is env_resolve.cuh, shared with kernel D (deferred_shade.cu), so the
// two kernels read the same words with the same weights: a segment at or
// beyond ceil8(cnt) (or past the staged budget) resolves to 0, bf16 pairs
// unpack as low half << 16 and high half & ~0xFFFF, and the blend keeps the
// TPU kernel's order with every product and sum rounded on its own
// (--fmad=false).
//
// What bounds it on an H100: bytes. Per tap it reads a record and two fracs
// (12 B, coalesced) and eight staged words (32 B, one per 128-int row of the
// page, so one 32 B sector each), and writes 16 B; there are a few flops per
// tap. Design: one thread per (tile, group, pixel) in the rec layout's own
// order, so the record, frac and output accesses of a warp are contiguous;
// the staged words are plain loads through L1/L2 (a tile's block is read by
// all of its pixels).

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_resolve.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const int* off;      // (tiles, G) group start page in the staged block
  const int* cnts;     // (tiles, G) group page counts
  const int* staged;   // (tiles, budget * 8, 128)
  const int* rec;      // (tiles, G, blocks, 128)
  const float* fx;     // (tiles, G, blocks, 128)
  const float* fy;     // (tiles, G, blocks, 128)
  float* out;          // (tiles, G, 4, blocks, 128)
  int64_t n;           // tiles * G * blocks * 128
  int budget, n_groups, plane;  // plane = blocks * 128
};

__global__ void __launch_bounds__(kThreads) env_resolve_kernel(Args a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int64_t tg = i / a.plane;             // t * G + g
  const int pix = (int)(i - tg * a.plane);
  const int t = (int)(tg / a.n_groups);
  float rgba[4];
  resolve_env_tap(a.staged + (size_t)t * a.budget * 8 * 128, a.budget, a.off[tg], a.cnts[tg],
                  a.rec[i], a.fx[i], a.fy[i], rgba);
  float* o = a.out + (size_t)tg * 4 * a.plane + pix;
#pragma unroll
  for (int c = 0; c < 4; ++c) o[(size_t)c * a.plane] = rgba[c];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int env_resolve_launch(const int* off, const int* cnts, const int* staged, int budget,
                                  const int* rec, const float* fx, const float* fy, int tiles,
                                  int n_groups, int blocks, float* out, void* stream) {
  if (tiles < 1 || n_groups < 1 || blocks < 1 || budget < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int plane = blocks * 128;
  const int64_t n = (int64_t)tiles * n_groups * plane;
  Args a{off, cnts, staged, rec, fx, fy, out, n, budget, n_groups, plane};
  const int64_t grid = (n + kThreads - 1) / kThreads;
  env_resolve_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
