// Two-kernel page cover for group caps above 128: the row scan and the
// per-pixel match.
//
// Replaces the TPU kernels direct12pbrrenderer_tpu/ops/texcache.py
// _block_cover_kernel (caller _block_cover_pallas) and _pix_match_kernel
// (caller _pix_match_pallas). Between them the tile level runs as torch glue
// (texcache._distinct_by_sort, a stable sort, as lax.sort is in JAX);
// texcache._cover_and_match_2level ties the three together.
//
// Semantics kept exactly (ops/cover_two_cuda.py has the plain versions):
//   * block_cover, per 128-pixel row of a (tiles, g, blocks, 128) page plane:
//     block_cap rounds of a min over the row's active pages not yet taken.
//     Round k writes its min m as candidate k (the sentinel 2^31-1 once the
//     row is exhausted) and marks the pixels whose page equals a live m with
//     slot k; the mark is NOT gated by act. Every pixel whose page equals m
//     leaves the pool. slot == block_cap means "no candidate of this row".
//   * pix_match, per pixel: slot = slotB[row, slotA], covered =
//     foundB[row, slotA] where slotA < block_cap; slot 0, not covered
//     otherwise (the caller gates covered by act).
//
// What bounds it on an H100: the per-pixel planes, 4 + 1 bytes in and 4
// bytes out per pixel and group for block_cover, 4 in and 4 + 1 out for
// pix_match (plus block_cap words per row); the rounds are block_cap warp
// reductions per row, small next to that. Design: block_cover runs one warp
// per row with its 4 pixels a lane in registers and a warp-min per round
// (a row stops at its first dead round: every later one is dead too);
// pix_match runs one thread per pixel and reads its row's slotB/foundB entry
// with one indexed load (the TPU kernel's block_cap-way select).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kRowsPerBlock = 4;  // warps (rows) per block_cover block

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void block_cover_kernel(const int* __restrict__ pages,
                                   const uint8_t* __restrict__ act, long long n_rows,
                                   int block_cap, int* __restrict__ cand_out,
                                   int* __restrict__ slot_out) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const size_t pix0 = (size_t)row * 128 + lane;
  int* cand = cand_out + (size_t)row * block_cap;

  int pg[4], v[4], slot[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pg[q] = pages[pix0 + 32 * q];
    v[q] = act[pix0 + 32 * q] != 0 ? pg[q] : kSentinel;
    slot[q] = block_cap;
  }
  for (int k = 0; k < block_cap; ++k) {
    const int m = warp_min(min(min(v[0], v[1]), min(v[2], v[3])));
    if (m == kSentinel) {  // warp-uniform: every later round is dead too
      for (int kk = k + lane; kk < block_cap; kk += 32) cand[kk] = kSentinel;
      break;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (pg[q] == m) {
        slot[q] = k;
        v[q] = kSentinel;
      }
    }
    if (lane == 0) cand[k] = m;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) slot_out[pix0 + 32 * q] = slot[q];
}

__global__ void pix_match_kernel(const int* __restrict__ slot_a, const int* __restrict__ slot_b,
                                 const uint8_t* __restrict__ found_b, long long n_pix,
                                 int block_cap, int* __restrict__ slot_out,
                                 uint8_t* __restrict__ cov_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pix) return;
  const int s = slot_a[i];
  int slot = 0;
  uint8_t cov = 0;
  if (s >= 0 && s < block_cap) {
    const size_t at = (size_t)(i >> 7) * block_cap + s;  // this pixel's row entry
    slot = slot_b[at];
    cov = found_b[at] != 0;
  }
  slot_out[i] = slot;
  cov_out[i] = cov;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). n_rows =
// tiles * g * blocks rows of 128 pixels.
extern "C" int block_cover_launch(const int* pages, const uint8_t* act, long long n_rows,
                                  int block_cap, int* cand_out, int* slot_out, void* stream) {
  if (n_rows < 1 || block_cap < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_cover_kernel<<<(unsigned)grid, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      pages, act, n_rows, block_cap, cand_out, slot_out);
  return (int)cudaGetLastError();
}

extern "C" int pix_match_launch(const int* slot_a, const int* slot_b, const uint8_t* found_b,
                                long long n_rows, int block_cap, int* slot_out,
                                uint8_t* cov_out, void* stream) {
  if (n_rows < 1 || block_cap < 1) return (int)cudaErrorInvalidValue;
  const long long n_pix = n_rows * 128;
  const long long grid = (n_pix + 255) / 256;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pix_match_kernel<<<(unsigned)grid, 256, 0, (cudaStream_t)stream>>>(
      slot_a, slot_b, found_b, n_pix, block_cap, slot_out, cov_out);
  return (int)cudaGetLastError();
}
