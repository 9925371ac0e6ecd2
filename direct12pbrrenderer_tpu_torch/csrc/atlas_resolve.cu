// Planar texture-cache resolve: the 5 material slots' taps in storage space.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/texcache.py _kernel
// (over _resolve_slot, _resolve_group, _fill_cascade; caller
// sample_atlas_tiled): per pixel of a tile, resolve every material slot's
// bilinear taps (both trilinear halves, or the cascade re-tap where sel is
// set) against the tile's staged RGBA8 quad pages and write the storage-space
// rgba, no sRGB, no shade: out (tiles, 5, 4, blocks, 128) f32.
//
// Semantics kept exactly (ops/atlas_resolve_cuda.py has the plain version):
// the tap resolve and the slot rule are tex_resolve.cuh's, shared with
// kernel C (resolve_shade.cu), so the two kernels resolve a slot with one
// body.
//
// What bounds it on an H100: per pixel it reads up to 10 groups x 4 staged
// words (scattered within the tile's staged pages, which the L2 holds) and
// 3 x 10 + 5 (+ 5 with the cascade) planar words, and writes 20: about 0.3 KB
// per pixel for a trilinear frame, bytes-bound (a few dozen flops per tap).
// Design: kernel C's — one thread per pixel, one block per 128-pixel tile
// row, one indexed load per corner word in place of the TPU kernel's
// lane-gather sweeps over 8-page chunks; the 20 outputs are written
// coalesced along the row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tex_resolve.cuh"

namespace {

// The kernel's inputs: contiguous (tiles, ..., blocks, 128) tensors.
struct Taps {
  const int* off;      // (tiles, G)
  const int* cnts;     // (tiles, cnt_cols)
  const int* staged;   // (tiles, B * 4, 128)
  const int* rec;      // (tiles, G, blocks, 128)
  const float* fx;
  const float* fy;
  const float* tl;     // (tiles, 5, blocks, 128)
  const int* sel;      // (tiles, 5, blocks, 128) or null
  int n_groups, cnt_cols, budget, blocks, trilinear;
};

// Group gi's bilinear tap of pixel `pix` of tile t, in storage space.
__device__ __forceinline__ void resolve_group(const Taps& a, int t, size_t pix, int gi,
                                              float rgba[4]) {
  const size_t at = ((size_t)t * a.n_groups + gi) * ((size_t)a.blocks * 128) + pix;
  int q[4];
  tex_resolve::tap_words(
      tex_resolve::tap_at(a.staged + (size_t)t * a.budget * 4 * 128, a.budget,
                          a.off[t * a.n_groups + gi], a.cnts[t * a.cnt_cols + gi], a.rec[at],
                          true),
      q);
  tex_resolve::blend(q, a.fx[at], a.fy[at], rgba);
}

__global__ void atlas_resolve_kernel(Taps a, float* __restrict__ out) {
  const int t = blockIdx.y;
  const size_t plane = (size_t)a.blocks * 128;
  const size_t pix = (size_t)blockIdx.x * 128 + threadIdx.x;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const size_t slot = ((size_t)t * 5 + s) * plane + pix;
    float rgba[4];
    tex_resolve::resolve_slot([&](int g, float v[4]) { resolve_group(a, t, pix, g, v); },
                              [&] { return a.tl[slot]; }, s, a.n_groups,
                              a.sel != nullptr && a.sel[slot] != 0, a.trilinear, rgba);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(((size_t)t * 5 + s) * 4 + c) * plane + pix] = rgba[c];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int atlas_resolve_launch(const int* off, const int* cnts, int cnt_cols,
                                    const int* staged, int budget, const int* rec,
                                    const float* fx, const float* fy, const float* tl,
                                    const int* sel, int tiles, int n_groups, int blocks,
                                    int trilinear, float* out, void* stream) {
  if (tiles < 1 || blocks < 1 || n_groups < 5 || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Taps a{off, cnts, staged, rec, fx, fy, tl, sel,
                            n_groups, cnt_cols, budget, blocks, trilinear};
  atlas_resolve_kernel<<<dim3(blocks, tiles), 128, 0, (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}
