// Device marks of the frame tracer (utils/trace.py).
//
// A mark is one thread that reads %globaltimer (ns) and stores it in a
// device ring of shape int64 [ring_frames, 2 + marks]: row r holds a frame's
// sequence number, its mark layout's id (the host's list of mark names) and
// one time a mark. The ring's row is counter % ring_frames, where `counter`
// is an int64 on the device: a frame's first mark advances it, clears the
// new row and stamps the sequence and the layout; every later mark writes
// into that row until the next frame's first mark. A replayed CUDA graph of
// a frame thus fills a row a frame with no host involvement, however many
// frames are in flight, and marks launched after the replay (eagerly, on the
// same stream) still land in the row of the frame they follow.
//
// `trace_now` writes one %globaltimer reading (the host's calibration of the
// timer against its own clock); `trace_step` spins reading the timer and
// writes the smallest nonzero step it saw (the timer's resolution).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__global__ void trace_mark_kernel(long long* ring, long long* counter, int ring_frames,
                                  int width, int col, int begin, int layout) {
  long long c = *counter;
  if (begin) {
    c += 1;
    *counter = c;
  }
  long long* row = ring + (c % ring_frames) * width;
  if (begin) {
    row[0] = c;
    row[1] = layout;
    for (int i = 2; i < width; ++i) row[i] = -1;
  }
  row[2 + col] = global_ns();
}

__global__ void trace_now_kernel(long long* out) { out[0] = global_ns(); }

__global__ void trace_step_kernel(long long* out, int iters) {
  long long best = 0x7fffffffffffffffLL;
  long long prev = global_ns();
  for (int i = 0; i < iters; ++i) {
    const long long t = global_ns();
    if (t != prev) {
      if (t - prev < best) best = t - prev;
      prev = t;
    }
  }
  out[0] = best;
}

}  // namespace

// Each launches one thread on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int trace_mark_launch(long long* ring, long long* counter, int ring_frames, int width,
                                 int col, int begin, int layout, void* stream) {
  if (ring_frames < 1 || col < 0 || col + 2 >= width) return (int)cudaErrorInvalidValue;
  trace_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(ring, counter, ring_frames, width, col,
                                                        begin, layout);
  return (int)cudaGetLastError();
}

extern "C" int trace_now_launch(long long* out, void* stream) {
  trace_now_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

extern "C" int trace_step_launch(long long* out, int iters, void* stream) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  trace_step_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
