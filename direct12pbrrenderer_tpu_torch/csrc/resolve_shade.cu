// Texture-cache tap resolve + G-buffer pixel shade, fused.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/texcache.py
// _resolve_shade_kernel (with _resolve_group, _resolve_slot, _fill_cascade):
// per pixel, resolve the 5 material slots' bilinear taps (both trilinear
// halves) against the tile's staged RGBA8 quad pages, then evaluate the
// gbuffer.hlsl pixel shade (ps_main :89-148) and write the 9 RGBA8-quantized
// G-buffer channels [albedo(3), emission, oct(2), roughness, metallic, ao].
//
// Semantics kept exactly (ops/resolve_shade_cuda.py has the plain version):
//   * the tap resolve is tex_resolve.cuh's, shared with kernel E
//     (atlas_resolve.cu);
//   * the shade is the TPU kernel's channel-form math in its order; RGBA8
//     quantization rounds half to even (rintf, as jnp.round); background
//     pixels are 0. Every product and sum is rounded separately (--fmad=false)
//     and constants are the double values rounded to float, as in JAX.
//
// What bounds it on an H100: per pixel it reads up to 10 groups x 4 staged
// words (scattered within the tile's staged pages, which the L2 holds) and
// 17 + 6 + 3 x 10 + 5 planar words, and writes 9: about 0.5 KB per pixel,
// about 1 GB for a 1080p frame. The shade is about 150 flops per pixel.
// Design: one thread per pixel, one block per 128-pixel tile row; the TPU
// kernel's lane-gather sweeps over 8-page chunks become one indexed load per
// corner word; all intermediate values stay in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tex_resolve.cuh"

namespace {

#define F(x) ((float)(x))

struct Args {
  tex_resolve::Taps taps;
  const float* attrs;  // (tiles, 17, blocks, 128)
  const int* flags;    // (tiles, 6, blocks, 128)
  float* out;          // (tiles, 9, blocks, 128)
};

// NaN-propagating clamp and max (jnp.clip / jnp.maximum semantics)
__device__ __forceinline__ float clip01(float x) { return x < 0.f ? 0.f : (x > 1.f ? 1.f : x); }
__device__ __forceinline__ float maxf(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float eotf(float c) {
  c = clip01(c);
  return c <= F(0.04045) ? c / F(12.92) : powf((c + F(0.055)) / F(1.055), F(2.4));
}

__device__ __forceinline__ float gamma_decode(float c) { return powf(maxf(c, 0.f), F(2.2)); }

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float n = sqrtf((x * x + y * y) + z * z);
  const float inv = 1.f / maxf(n, F(1e-20));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float q8(float x) { return rintf(clip01(x) * 255.f) * F(1.0 / 255.0); }

__global__ void resolve_shade_kernel(Args a) {
  const int t = blockIdx.y;
  const size_t plane = (size_t)a.taps.blocks * 128;
  const size_t pix = (size_t)blockIdx.x * 128 + threadIdx.x;
  auto attr = [&](int c) { return a.attrs[((size_t)t * 17 + c) * plane + pix]; };
  auto flag = [&](int c) { return a.flags[((size_t)t * 6 + c) * plane + pix] != 0; };

  float smp[5][4];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    tex_resolve::resolve_slot(a.taps, t, pix, s, smp[s]);
    if (flag(s)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) smp[s][c] = eotf(smp[s][c]);
    }
  }
  const bool mask = flag(5);

  float nx = attr(0), ny = attr(1), nz = attr(2);
  float tx = attr(3), ty = attr(4), tz = attr(5);
  norm3(nx, ny, nz);
  norm3(tx, ty, tz);
  bool use[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) use[i] = attr(12 + i) > 0.5f;

  // normal mapping: TBN with bitangent = cross(N, T) (gbuffer.hlsl:63-69)
  const float bx = ny * tz - nz * ty;
  const float by = nz * tx - nx * tz;
  const float bz = nx * ty - ny * tx;
  const float sx = smp[1][0] * 2.f - 1.f, sy = smp[1][1] * 2.f - 1.f, sz = smp[1][2] * 2.f - 1.f;
  float mx = tx * sx + bx * sy + nx * sz;
  float my = ty * sx + by * sy + ny * sz;
  float mz = tz * sx + bz * sy + nz * sz;
  norm3(mx, my, mz);
  const float wx = use[1] ? mx : nx;
  const float wy = use[1] ? my : ny;
  const float wz = use[1] ? mz : nz;

  float ch[9];
#pragma unroll
  for (int c = 0; c < 3; ++c) ch[c] = gamma_decode(use[0] ? smp[0][c] : attr(6 + c));
  ch[3] = attr(9);                                  // emission
  // octahedral encode (common.encode_octahedron, channel form)
  const float ssum = fabsf(wx) + fabsf(wy) + fabsf(wz);
  const float dx = wx / ssum, dy = wy / ssum, dz = wz / ssum;
  const float fx0 = (dx < 0.f ? -1.f : 1.f) * (1.f - fabsf(dy));
  const float fy0 = (dy < 0.f ? -1.f : 1.f) * (1.f - fabsf(dx));
  ch[4] = (dz < 0.f ? fx0 : dx) * 0.5f + 0.5f;
  ch[5] = (dz < 0.f ? fy0 : dy) * 0.5f + 0.5f;
  ch[6] = use[3] ? smp[3][0] : attr(10);            // roughness
  ch[7] = use[2] ? smp[2][0] : attr(11);            // metallic
  ch[8] = use[4] ? smp[4][0] : 0.f;                 // AO defaults to 0 (hlsl:135-138)
#pragma unroll
  for (int c = 0; c < 9; ++c) a.out[((size_t)t * 9 + c) * plane + pix] = mask ? q8(ch[c]) : 0.f;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int resolve_shade_launch(const int* off, const int* cnts, int cnt_cols,
                                    const int* staged, int budget, const int* rec,
                                    const float* fx, const float* fy, const float* tl,
                                    const float* attrs, const int* flags, const int* sel,
                                    int tiles, int n_groups, int blocks, int trilinear,
                                    float* out, void* stream) {
  if (tiles < 1 || blocks < 1 || n_groups < 5) return (int)cudaErrorInvalidValue;
  Args a{{off, cnts, staged, rec, fx, fy, tl, sel, n_groups, cnt_cols, budget, blocks,
          trilinear},
         attrs, flags, out};
  resolve_shade_kernel<<<dim3(blocks, tiles), 128, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
