// The grid of a persistent kernel: as many blocks as fit on the current
// device at once. Shared by the depth fold of kernels A and H
// (raster_fold.cuh) and the page cover, kernel B (fused_cover.cu).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace persistent {

// Sets *blocks_out to the number of blocks of `threads` threads and `smem`
// bytes of dynamic shared memory that fit on the current device at once,
// first raising the kernel's dynamic shared memory limit to `smem` where it
// is below (never lowering it, so a grid kept for a larger size stays
// launchable). The last 16 (kernel, device, threads, shared memory) grids
// are kept, so a repeated configuration makes no attribute or occupancy
// query. Returns the CUDA error (0 = *blocks_out set).
template <class Kernel>
inline int grid(Kernel kernel, int threads, size_t smem, int* blocks_out) {
  struct Entry {
    const void* fn;
    int dev, threads;
    size_t smem;
    int blocks;
  };
  constexpr int kEntries = 16;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int n_cache = 0, next = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_cache; ++i) {
      const Entry& c = cache[i];
      if (c.fn == fn && c.dev == dev && c.threads == threads && c.smem == smem) {
        *blocks_out = c.blocks;
        return 0;
      }
    }
  }
  cudaFuncAttributes attr;
  int sms = 0, per_sm = 0;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess && (size_t)attr.maxDynamicSharedSizeBytes < smem)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks_out = sms * per_sm;
  std::lock_guard<std::mutex> lock(mu);
  cache[next] = Entry{fn, dev, threads, smem, sms * per_sm};
  next = (next + 1) % kEntries;
  if (n_cache < kEntries) ++n_cache;
  return 0;
}

}  // namespace persistent
