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
// of the four corners, per channel, in the TPU kernel's order. Kernel F
// resolves one tap at a time (resolve_env_tap); kernel D computes all of a
// pixel's tap addresses (env_tap_at), then issues their loads
// (env_tap_words), then blends (env_tap_blend).
#pragma once

#include <stddef.h>
#include <stdint.h>

// Where a tap reads: the first of its 8 packed words, at staged_tile (this
// tile's (budget * 8, 128) int32 block) + (base + seg) * 8 * 128 + (rc &
// 127), and whether it reads at all (need false, or a segment out of the
// group's span: the words are 0). The address of a tap that reads nothing is
// clamped to page 0, so the loads of many taps can be issued together.
struct EnvTapAt {
  const int* p;
  bool ok;
};

__device__ __forceinline__ EnvTapAt env_tap_at(const int* staged_tile, int budget, int base,
                                               int cnt, int rc, bool need) {
  const int seg = rc >> 7;
  const bool ok = need && seg >= 0 && seg < (cnt + 7) / 8 * 8 && base + seg < budget;
  return {staged_tile + (size_t)(ok ? base + seg : 0) * 8 * 128 + (rc & 127), ok};
}

// The tap's 8 packed words: independent read-only loads, predicated.
__device__ __forceinline__ void env_tap_words(const EnvTapAt& at, unsigned w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = 0;
    if (at.ok) w[k] = (unsigned)__ldg(at.p + k * 128);
  }
}

// The clamp quad's bilinear blend: rgba[4].
__device__ __forceinline__ void env_tap_blend(const unsigned w[8], float fx, float fy,
                                              float rgba[4]) {
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

// One tap: base/cnt are the group's first staged page and page count; rc,
// fx, fy the tap's record and fracs. Writes rgba[4].
__device__ __forceinline__ void resolve_env_tap(const int* staged_tile, int budget, int base,
                                                int cnt, int rc, float fx, float fy,
                                                float rgba[4]) {
  unsigned w[8];
  env_tap_words(env_tap_at(staged_tile, budget, base, cnt, rc, true), w);
  env_tap_blend(w, fx, fy, rgba);
}
