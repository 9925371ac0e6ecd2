// The per-pixel planes of kernels C (resolve_shade.cu) and D
// (deferred_shade.cu), read in place through their strides.
//
// A plane is a (tiles, G, blocks, 128) tensor of 4-byte words as the caller
// built it: no copy. ops/tap_planes.py takes two layouts and raises on any
// other:
//   * lane-contiguous (lane stride 1): a warp's read of one group is 128
//     contiguous bytes, one line;
//   * group-innermost (group stride 1, lane stride S, G <= S <= 32): the tap
//     planes that the texture plan stacks with the group last, and channels
//     2..18 of the raster rows (S = 24). A pixel's words lie within 128
//     bytes, so the lines a warp's first read brings into L1 serve its
//     reads of the other groups.
// A copy into (tiles, G, blocks, 128) cost more device time than either
// kernel. Staging each row through shared memory (cp.async, with or without
// a ring of persistent blocks) measured slower than these direct reads: the
// shared memory cut the blocks in flight on an SM.

#pragma once

#include <stdint.h>

namespace tap_planes {

struct Plane {
  const void* p;             // element (0, 0, 0, 0)
  long long st, sg, sr, sx;  // element strides: tile, group, row, lane
};

// Row r of tile t of a plane: word (g, x) through read-only loads.
struct Row {
  const uint32_t* p;
  int lg, lx;
  __device__ __forceinline__ uint32_t operator()(int g, int x) const {
    return __ldg(p + g * lg + x * lx);
  }
};

__device__ __forceinline__ Row row(const Plane& pl, int t, int r) {
  return {(const uint32_t*)pl.p + t * pl.st + r * pl.sr, (int)pl.sg, (int)pl.sx};
}

// The planes of a launch from the host's pointers and (n, 4) strides.
inline void planes_from(const void* const* ptrs, const long long* strides, int n, Plane* out) {
  for (int i = 0; i < n; ++i) {
    const long long* s = strides + 4 * i;
    out[i] = Plane{ptrs[i], s[0], s[1], s[2], s[3]};
  }
}

}  // namespace tap_planes
