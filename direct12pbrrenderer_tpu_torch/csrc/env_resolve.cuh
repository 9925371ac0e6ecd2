// One env-cache tap resolved against a tile's staged bf16 pages.
//
// The shared body of TPU direct12pbrrenderer_tpu/ops/envcache.py
// _resolve_env_group, included by kernel F (env_resolve.cu) and kernel D
// (deferred_shade.cu). A tap reads the 8 packed words at
// staged[(base + seg) * 8 + k][rec & 127] of its tile, seg = rec >> 7; a
// segment at or beyond ceil8(cnt) (or past the staged budget) resolves to 0,
// as the TPU kernel sweeps whole 8-page chunks of the group's span. Value v of
// the clamp quad is the bf16 in word v >> 1: low half << 16, high half &
// ~0xFFFF, bit cast to float (envcache.py:274-277). Then the bilinear blend
// of the four corners, per channel, in the TPU kernel's order.
#pragma once

#include <stdint.h>

// staged_tile: this tile's (budget * 8, 128) int32 block; base/cnt: the
// group's first staged page and page count; rc/fx/fy: the tap's record and
// fracs. Writes rgba[4].
__device__ __forceinline__ void resolve_env_tap(const int* staged_tile, int budget, int base,
                                                int cnt, int rc, float fx, float fy,
                                                float rgba[4]) {
  const int seg = rc >> 7;
  const int ln = rc & 127;
  unsigned w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (seg >= 0 && seg < (cnt + 7) / 8 * 8 && base + seg < budget) {
    const int* p = staged_tile + (size_t)(base + seg) * 8 * 128 + ln;
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = (unsigned)p[k * 128];
  }
  auto val = [&](int v) {
    const unsigned word = w[v >> 1];
    return __uint_as_float((v & 1) ? (word & 0xFFFF0000u) : (word << 16));
  };
  const float w00 = (1.f - fx) * (1.f - fy);
  const float w01 = fx * (1.f - fy);
  const float w10 = (1.f - fx) * fy;
  const float w11 = fx * fy;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    rgba[c] = val(c) * w00 + val(4 + c) * w01 + val(8 + c) * w10 + val(12 + c) * w11;
  }
}
