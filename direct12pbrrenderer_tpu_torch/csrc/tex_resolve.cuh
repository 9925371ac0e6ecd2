// The texture cache's tap resolve, shared by kernel C (resolve_shade.cu, the
// fused G-buffer) and kernel E (atlas_resolve.cu, the planar path), so both
// resolve a tap with one body.
//
// Replaces the TPU helpers direct12pbrrenderer_tpu/ops/texcache.py
// _resolve_group, _resolve_slot and _fill_cascade. Semantics kept exactly
// (ops/resolve_shade_cuda.py has the plain version, `_resolve_slot`):
//   * a tap reads the 4 corner words at staged[t, (off + seg) * 4 + k, rec &
//     127] with seg = rec >> 7; a segment at or beyond ceil8(cnt) resolves to 0
//     (the TPU kernel sweeps whole 8-page chunks of the group's span);
//   * bilinear blend in _resolve_group's association order, trilinear as
//     lo * (1 - frac) + hi * frac; with the cascade, a tap whose sel is set
//     reads the cascade group instead (sel implies the tile's cascade flag,
//     so the TPU kernel's per-tile gate changes nothing).
// Every product and sum is rounded separately (the kernels are built with
// --fmad=false), as XLA evaluates them.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace tex_resolve {

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
  const size_t plane = (size_t)a.blocks * 128;
  const size_t at = ((size_t)t * a.n_groups + gi) * plane + pix;
  const int base = a.off[t * a.n_groups + gi];
  const int cnt = a.cnts[t * a.cnt_cols + gi];
  const int rc = a.rec[at];
  const int seg = rc >> 7;
  const int ln = rc & 127;
  const int lim = (cnt + 7) / 8 * 8;
  int q[4] = {0, 0, 0, 0};
  if (seg >= 0 && seg < lim && base + seg < a.budget) {
    const int* p = a.staged + ((size_t)t * a.budget * 4 + (size_t)(base + seg) * 4) * 128 + ln;
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = p[k * 128];
  }
  const float fx = a.fx[at], fy = a.fy[at];
  const float ofx = 1.f - fx, ofy = 1.f - fy;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float tc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) tc[k] = (float)((q[k] >> (8 * c)) & 0xFF) * (float)(1.0 / 255.0);
    rgba[c] = tc[0] * ofx * ofy + tc[1] * fx * ofy + tc[2] * ofx * fy + tc[3] * fx * fy;
  }
}

// Material slot s's tap (both trilinear halves, or the cascade re-tap).
__device__ __forceinline__ void resolve_slot(const Taps& a, int t, size_t pix, int s,
                                             float rgba[4]) {
  const size_t plane = (size_t)a.blocks * 128;
  if (a.sel != nullptr && a.sel[((size_t)t * 5 + s) * plane + pix] != 0) {
    resolve_group(a, t, pix, a.n_groups - 5 + s, rgba);  // the cascade re-tap
    return;
  }
  resolve_group(a, t, pix, s, rgba);
  if (a.trilinear) {
    float hi[4];
    resolve_group(a, t, pix, 5 + s, hi);
    const float frac = a.tl[((size_t)t * 5 + s) * plane + pix];
#pragma unroll
    for (int c = 0; c < 4; ++c) rgba[c] = rgba[c] * (1.f - frac) + hi[c] * frac;
  }
}

}  // namespace tex_resolve
