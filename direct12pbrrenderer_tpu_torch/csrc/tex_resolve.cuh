// The texture cache's tap resolve, shared by kernel C (resolve_shade.cu, the
// fused G-buffer) and kernel E (atlas_resolve.cu, the planar path), so both
// resolve a tap and assemble a slot with one body: tap_at (address and
// predicate), tap_words (the staged gathers), blend, and resolve_slot (the
// trilinear and cascade rule). Kernel C gathers all of a pixel's taps first
// and hands resolve_slot blends of gathered words; kernel E hands it taps
// that gather as they blend, one after another.
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

// Where a tap reads: the first of its 4 corner words, at this tile's staged
// block + ((base + seg) * 4) * 128 + (rc & 127), and whether it reads at
// all. A segment at or beyond ceil8(cnt) or past the budget reads nothing
// and resolves to 0, as does a tap that is not needed (need false). The
// address of a tap that reads nothing is clamped to page 0, so every tap's
// address is valid and the loads can be issued together.
struct TapAt {
  const int* p;
  bool ok;
};

__device__ __forceinline__ TapAt tap_at(const int* staged_tile, int budget, int base, int cnt,
                                        int rc, bool need) {
  const int seg = rc >> 7;
  const int lim = (cnt + 7) / 8 * 8;
  const bool ok = need && seg >= 0 && seg < lim && base + seg < budget;
  return {staged_tile + (size_t)(ok ? base + seg : 0) * 4 * 128 + (rc & 127), ok};
}

// The tap's 4 corner words (0 where it reads nothing): independent
// read-only loads, predicated rather than branched around.
__device__ __forceinline__ void tap_words(const TapAt& at, int q[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[k] = 0;
    if (at.ok) q[k] = __ldg(at.p + k * 128);
  }
}

// The bilinear blend of the 4 corner words, per RGBA8 channel.
__device__ __forceinline__ void blend(const int q[4], float fx, float fy, float rgba[4]) {
  const float ofx = 1.f - fx, ofy = 1.f - fy;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float tc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) tc[k] = (float)((q[k] >> (8 * c)) & 0xFF) * (float)(1.0 / 255.0);
    rgba[c] = tc[0] * ofx * ofy + tc[1] * fx * ofy + tc[2] * ofx * fy + tc[3] * fx * fy;
  }
}

// Material slot s's rgba (_resolve_slot with _fill_cascade): where sel is
// set, the cascade re-tap (group n_groups - 5 + s); otherwise the lo tap
// (group s), lerped with the hi tap (group 5 + s) by the trilinear frac.
// tap(g, rgba) gives group g's bilinear tap, frac() the slot's frac; neither
// is called for a tap or a frac that the slot does not read.
template <class Tap, class Frac>
__device__ __forceinline__ void resolve_slot(const Tap& tap, const Frac& frac, int s, int n_groups,
                                             bool sel, bool trilinear, float rgba[4]) {
  if (sel) {
    tap(n_groups - 5 + s, rgba);
    return;
  }
  tap(s, rgba);
  if (trilinear) {
    float hi[4];
    tap(5 + s, hi);
    const float f = frac();
#pragma unroll
    for (int c = 0; c < 4; ++c) rgba[c] = rgba[c] * (1.f - f) + hi[c] * f;
  }
}

}  // namespace tex_resolve
