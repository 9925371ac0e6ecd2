// The anisotropic sampler: footprint and four trilinear taps in one pass.
//
// Replaces no TPU kernel: the JAX package's
// direct12pbrrenderer_tpu/ops/gbuffer.py sample_atlas_anisotropic (:133) is
// XLA glue. One thread per pixel of the (H, W) frame. At a covered pixel,
// for each of the 5 material slots whose `use` is set, the thread takes the
// 2x2-quad differences of uv (both pixels of a pair share the difference,
// as _quad_derivatives does), the footprint (the gradients in texels of the
// slot's texture, the aniso ratio capped at 4, the lod of the minor axis,
// the major axis), then four trilinear taps at t = -0.375, -0.125, 0.125,
// 0.375 along the major axis. Each tap is two bilinear wrap samples of the
// atlas (one 16-byte load of the quad record a corner set), the mip blend
// and the sRGB decode where the texture is flagged; the taps are summed in
// order and the sum scaled by 1/4. The thread writes the slot's rgba into
// samples (H, W, 5, 4) f32; an unused slot, a background pixel and a
// texture id outside the table get 0.
//
// Semantics kept exactly (ops/aniso_cuda.py has the plain version,
// `aniso_sample_reference`, which is sample_atlas_anisotropic at the active
// pairs): every product and sum is rounded separately (--fmad=false) in the
// plain filter's order; the texel coordinate x = u * w - 0.5, its floor and
// fraction, the wrap as torch.remainder (non-negative for negative texel
// coordinates); the corner blend and the 1/255 unpack are
// tex_resolve.cuh's `blend`, common.bilerp's association; the mip blend
// c0 * (1 - frac) + c1 * frac; the lod clamped to [0, n_mips - 1] and the
// upper mip to the last; precise sqrtf, log2f and powf. A division by a
// constant is a multiply by its reciprocal taken in double and rounded to
// float, as PyTorch's CUDA division by a Python float computes it, and each
// other constant is the plain version's Python float rounded to float, so
// the plain version run on the card gives the same bits.
//
// What bounds it on an H100: per pixel it reads uv at the pixel and its
// quad neighbours, the mask, the 5 use flags and texture ids, and writes
// 80 bytes of samples; the atlas's quad records (2 per tap, 16 bytes each)
// come from the L2 for an atlas that fits there. Bytes-bound at about 0.1
// ms for a 1080p frame. Design: one pass and no intermediate tensors; the
// inactive (pixel, slot) pairs are skipped by predication, since a
// compaction would need its count on the host, which a captured frame
// cannot read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tex_resolve.cuh"

namespace {

constexpr int kTaps = 4;
constexpr int kSlots = 5;
constexpr float kRatioMax = 4.f;
constexpr float kTiny = (float)1e-12;   // the squared lengths' floor

// The atlas's tables (ops/gbuffer.AtlasDevice), contiguous.
struct Atlas {
  const int4* data;        // (N, 4) int32 quad records
  const int* page_base;    // (T, max_mips)
  const int* base_size;    // (T, 2)
  const int* n_mips;       // (T,)
  const bool* srgb;        // (T,)
  int max_mips, n_tex;
};

// The per-pixel fields, read through their strides (elements).
struct Fields {
  const float* uv;          // (H, W, 2)
  const bool* mask;         // (H, W)
  const bool* use;          // (H, W, 5)
  const long long* tex;     // (H, W, 5)
  long long uv_s[3], mask_s[2], use_s[3], tex_s[3];
  int h, w;
};

// The wrap sample of mip `mip` (clamped to the texture's last) at (u, v),
// storage-space rgba: gbuffer._sample_mip_bilinear.
__device__ __forceinline__ void bilinear(const Atlas& a, int tex, long long mip, int nm, float u,
                                         float v, float rgba[4]) {
  mip = mip < nm - 1 ? mip : nm - 1;
  const long long bw = a.base_size[2 * tex] >> mip;
  const long long bh = a.base_size[2 * tex + 1] >> mip;
  const long long w = bw > 1 ? bw : 1;
  const long long h = bh > 1 ? bh : 1;
  const long long off = a.page_base[(long long)tex * a.max_mips + mip];
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  long long x0 = (long long)x0f % w;
  long long y0 = (long long)y0f % h;
  if (x0 < 0) x0 += w;
  if (y0 < 0) y0 += h;
  const long long pages_x = (w + 15) >> 4;
  const long long page = off + (y0 >> 3) * pages_x + (x0 >> 4);
  const int4 q4 = __ldg(a.data + page * 128 + (y0 & 7) * 16 + (x0 & 15));
  const int q[4] = {q4.x, q4.y, q4.z, q4.w};
  tex_resolve::blend(q, fx, fy, rgba);
}

// common.srgb_eotf of one channel.
__device__ __forceinline__ float srgb_eotf(float c) {
  c = c < 0.f ? 0.f : (c > 1.f ? 1.f : c);
  return c <= (float)0.04045 ? c * (float)(1.0 / 12.92)
                             : powf((c + (float)0.055) * (float)(1.0 / 1.055), (float)2.4);
}

// One trilinear tap, sRGB-linearized where flagged: gbuffer.sample_atlas_raw
// (trilinear) under apply_srgb.
__device__ __forceinline__ void trilinear(const Atlas& a, int tex, float u, float v, float lod,
                                          float rgba[4]) {
  const int nm = a.n_mips[tex];
  lod = lod < 0.f ? 0.f : lod;
  const float last = (float)(nm - 1);
  lod = lod > last ? last : lod;
  const long long m0 = (long long)floorf(lod);
  const float frac = lod - (float)m0;
  float c0[4], c1[4];
  bilinear(a, tex, m0, nm, u, v, c0);
  bilinear(a, tex, m0 + 1, nm, u, v, c1);
#pragma unroll
  for (int c = 0; c < 4; ++c) rgba[c] = c0[c] * (1.f - frac) + c1[c] * frac;
  if (a.srgb[tex]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgba[c] = srgb_eotf(rgba[c]);
  }
}

__global__ void __launch_bounds__(256) aniso_sample_kernel(Atlas a, Fields f,
                                                           float4* __restrict__ out) {
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (long long)f.h * f.w) return;
  const int y = (int)(pix / f.w), x = (int)(pix % f.w);
  float4* o = out + pix * kSlots;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!f.mask[y * f.mask_s[0] + x * f.mask_s[1]]) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) o[s] = zero;
    return;
  }
  // uv at the pixel and the quad differences: x pairs (x & ~1, x | 1), y
  // pairs (y & ~1, y | 1)
  const float* uv = f.uv + y * f.uv_s[0] + x * f.uv_s[1];
  const float* px0 = f.uv + y * f.uv_s[0] + (x & ~1) * f.uv_s[1];
  const float* py0 = f.uv + (y & ~1) * f.uv_s[0] + x * f.uv_s[1];
  const float u = uv[0], v = uv[f.uv_s[2]];
  const float ddx0 = px0[f.uv_s[1]] - px0[0];
  const float ddx1 = px0[f.uv_s[1] + f.uv_s[2]] - px0[f.uv_s[2]];
  const float ddy0 = py0[f.uv_s[0]] - py0[0];
  const float ddy1 = py0[f.uv_s[0] + f.uv_s[2]] - py0[f.uv_s[2]];
  const bool* use = f.use + y * f.use_s[0] + x * f.use_s[1];
  const long long* texp = f.tex + y * f.tex_s[0] + x * f.tex_s[1];
  for (int s = 0; s < kSlots; ++s) {
    const long long t = texp[s * f.tex_s[2]];
    if (!use[s * f.use_s[2]] || t < 0 || t >= a.n_tex) {
      o[s] = zero;
      continue;
    }
    const int tex = (int)t;
    // the footprint: gradients in texels, ratio, lod, major axis
    const float sw = (float)a.base_size[2 * tex], sh = (float)a.base_size[2 * tex + 1];
    const float gx0 = ddx0 * sw, gx1 = ddx1 * sh;
    const float gy0 = ddy0 * sw, gy1 = ddy1 * sh;
    const float rx2 = gx0 * gx0 + gx1 * gx1;
    const float ry2 = gy0 * gy0 + gy1 * gy1;
    const float rho2 = rx2 > ry2 ? rx2 : ry2;
    float rho_min2 = rx2 < ry2 ? rx2 : ry2;
    rho_min2 = rho_min2 < kTiny ? kTiny : rho_min2;
    float ratio = sqrtf(rho2 / rho_min2);
    ratio = ratio < 1.f ? 1.f : (ratio > kRatioMax ? kRatioMax : ratio);
    const float lod = 0.5f * log2f(rho2 < kTiny ? kTiny : rho2) - log2f(ratio);
    const bool along_x = rx2 >= ry2;
    const float mu = along_x ? ddx0 : ddy0;
    const float mv = along_x ? ddx1 : ddy1;
    // the four taps along the major axis, summed in order
    float acc[4];
#pragma unroll
    for (int i = 0; i < kTaps; ++i) {
      const float tt = ((float)i + 0.5f) / (float)kTaps - 0.5f;
      float rgba[4];
      trilinear(a, tex, u + mu * tt, v + mv * tt, lod, rgba);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = i == 0 ? rgba[c] : acc[c] + rgba[c];
    }
    o[s] = make_float4(acc[0] * 0.25f, acc[1] * 0.25f, acc[2] * 0.25f, acc[3] * 0.25f);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int aniso_sample_launch(const int* data, const int* page_base, int max_mips,
                                   const int* base_size, const int* n_mips, const bool* srgb,
                                   int n_tex, const float* uv, const long long* uv_s,
                                   const bool* mask, const long long* mask_s, const bool* use,
                                   const long long* use_s, const long long* tex,
                                   const long long* tex_s, int h, int w, float* out,
                                   void* stream) {
  if (h < 2 || w < 2 || (h & 1) || (w & 1) || n_tex < 1 || max_mips < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Atlas a{reinterpret_cast<const int4*>(data), page_base, base_size, n_mips, srgb, max_mips,
          n_tex};
  Fields f{uv, mask, use, tex, {}, {}, {}, {}, h, w};
  for (int i = 0; i < 3; ++i) {
    f.uv_s[i] = uv_s[i];
    f.use_s[i] = use_s[i];
    f.tex_s[i] = tex_s[i];
  }
  f.mask_s[0] = mask_s[0];
  f.mask_s[1] = mask_s[1];
  const long long n = (long long)h * w;
  aniso_sample_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      a, f, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
