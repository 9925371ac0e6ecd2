// Fused two-level page cover for the texture and env page caches.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/texcache.py
// _fused_cover_kernel_batched (body _fused_cover_batched_body; same outputs as
// _fused_cover_kernel and _fused_cover_kernel_dyn): per (tile, group) of a
// (tiles, g, blocks, 128) page/active plane, the ascending list of distinct
// pages the tile touches, its count, and every pixel's slot in that list and
// whether it is covered.
//
// Semantics kept exactly (ops/cover_cuda.py has the plain version):
//   * row level: block_cap rounds of a min over the row's active pages not
//     yet taken; round k's min m marks the pixels whose page equals m (slot
//     k) when m is live. The mark is NOT gated by act (an inactive pixel whose
//     page equals a candidate gets a slot, never coverage). Every pixel whose
//     page equals m leaves the pool.
//   * tile level: candidate j's rank is the number of distinct candidates
//     below it (first occurrences only), which is the ascending order of the
//     TPU kernel's rank-matrix merge. count = min(distinct, cap_g); the list
//     holds the first count distinct pages and 0 past them.
//   * pixel: slot = min(rank, cap_g - 1), covered = rank < cap_g && act; an
//     unmatched pixel gets slot 0, covered 0. An all-inactive group is all 0.
//
// What bounds it on an H100: the reads and writes of the per-pixel planes,
// 4 + 1 bytes in, 4 + 1 bytes out per pixel and group (about 52 MB for one
// 1080p call with g = 5); the row rounds are block_cap warp reductions per row
// and the merge is O(candidates^2) compares on shared memory per group, both
// small next to that. Design: one thread block per (tile, group), one warp per
// 128-pixel row holding its 4 pixels a lane in registers; a row stops its
// rounds at the first dead min (all later ones are dead too); candidates,
// first-occurrence flags and ranks live in shared memory, where every thread
// of the merge reads the same candidate at once (a broadcast).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxGroups = 16;

// per-group caps, passed by value (outside the anonymous namespace: the
// exported launch function takes it, and must keep external linkage)
struct Caps {
  int v[kMaxGroups];
};

namespace {

constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void fused_cover_kernel(const int* __restrict__ pages,
                                   const uint8_t* __restrict__ act, int g, int blocks,
                                   int block_cap, int cap_max, Caps caps,
                                   int* __restrict__ list_out, int* __restrict__ cnt_out,
                                   int* __restrict__ slot_out, uint8_t* __restrict__ cov_out) {
  extern __shared__ int smem[];
  const int n0 = blocks * block_cap;  // candidates, k-major: j = k * blocks + row
  int* s_cand = smem;
  int* s_first = smem + n0;
  int* s_rank = smem + 2 * n0;
  __shared__ int s_list[128];
  __shared__ int s_cnt;

  const int tg = blockIdx.x;  // tile * g + group
  const int cap_g = caps.v[tg % g];
  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const size_t pix0 = ((size_t)tg * blocks + row) * 128 + lane;

  // ---- row level: up to block_cap distinct pages of this row, ascending --
  int pg[4], v[4], slot_a[4];
  bool ac[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pg[q] = pages[pix0 + 32 * q];
    ac[q] = act[pix0 + 32 * q] != 0;
    v[q] = ac[q] ? pg[q] : kSentinel;
    slot_a[q] = block_cap;  // "no candidate of this row"
  }
  for (int k = 0; k < block_cap; ++k) {
    const int m = warp_min(min(min(v[0], v[1]), min(v[2], v[3])));
    if (m == kSentinel) {  // warp-uniform: every later round is dead too
      for (int kk = k + lane; kk < block_cap; kk += 32) s_cand[kk * blocks + row] = kSentinel;
      break;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (pg[q] == m) {
        slot_a[q] = k;
        v[q] = kSentinel;
      }
    }
    if (lane == 0) s_cand[k * blocks + row] = m;
  }
  for (int i = threadIdx.x; i < 128; i += nthreads) s_list[i] = 0;
  if (threadIdx.x == 0) s_cnt = 0;
  __syncthreads();

  // ---- tile level: first occurrences, then ranks among distinct values ----
  for (int j = threadIdx.x; j < n0; j += nthreads) {
    const int c = s_cand[j];
    int f = c != kSentinel;
    for (int i = 0; f && i < j; ++i) f = s_cand[i] != c;
    s_first[j] = f;
  }
  __syncthreads();
  int local = 0;
  for (int j = threadIdx.x; j < n0; j += nthreads) {
    const int c = s_cand[j];
    int rank = cap_max;
    if (c != kSentinel) {
      rank = 0;
      for (int i = 0; i < n0; ++i) rank += s_first[i] && s_cand[i] < c;
    }
    s_rank[j] = rank;
    local += s_first[j];
  }
  if (local) atomicAdd(&s_cnt, local);
  __syncthreads();
  const int cnt_g = min(s_cnt, cap_g);
  for (int j = threadIdx.x; j < n0; j += nthreads) {
    if (s_first[j] && s_rank[j] < cnt_g) s_list[s_rank[j]] = s_cand[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap_max; i += nthreads) {
    list_out[(size_t)tg * cap_max + i] = s_list[i];
  }
  if (threadIdx.x == 0) cnt_out[tg] = cnt_g;

  // ---- per pixel: slot and coverage through the row candidate's rank -----
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int slot = 0;
    bool cov = false;
    if (slot_a[q] < block_cap) {
      const int rk = s_rank[slot_a[q] * blocks + row];
      slot = min(rk, cap_g - 1);
      cov = rk < cap_g && ac[q];
    }
    slot_out[pix0 + 32 * q] = slot;
    cov_out[pix0 + 32 * q] = cov;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int fused_cover_launch(const int* pages, const uint8_t* act, int tiles, int g,
                                  int blocks, int block_cap, int cap_max, Caps caps,
                                  int* list_out, int* cnt_out, int* slot_out,
                                  uint8_t* cov_out, void* stream) {
  if (g < 1 || g > kMaxGroups || blocks < 1 || blocks > 32 || block_cap < 1 ||
      cap_max < 1 || cap_max > 128) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)3 * blocks * block_cap * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  fused_cover_kernel<<<tiles * g, 32 * blocks, smem, (cudaStream_t)stream>>>(
      pages, act, g, blocks, block_cap, cap_max, caps, list_out, cnt_out, slot_out, cov_out);
  return (int)cudaGetLastError();
}
