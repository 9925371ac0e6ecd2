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
// What bounds it on an H100: bytes. Per pixel it may read 3 x G + 5 + 17 +
// 6 (+ 5 with the cascade) planar words and up to 4 staged words per tap
// (scattered within the tile's staged pages, which the L2 holds), and
// writes 9; a background pixel's output reads only its coverage flag, a lit
// one's only the taps of the slots whose maps it uses. The shade is about
// 150 flops. What kept a kernel from that: the
// trilinear fracs arrive with the group innermost and attrs is a channel
// slice of the raster rows, and copying them into (tiles, G, blocks, 128)
// cost as much device time as the kernel; and a pixel's 10-15 taps each
// waited on a load -> gather chain in turn. This design:
//   * reads every plane in place through its strides (tap_planes.cuh);
//   * one thread per pixel, one block per 128-pixel tile row;
//   * a pixel first computes every tap's address and predicate, then
//     issues all of its staged gathers as independent loads, then blends:
//     the blend and the shade are the same operations in the same order;
//   * a background pixel writes its zeros and reads nothing but its
//     coverage flag; on a lit one, a tap whose result the output does not
//     read (a slot's whose map the material does not use, one that the
//     cascade mask switches off) is predicated off: neither its record, its
//     fracs nor its staged words are read, and its blend, which no select
//     takes, is 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tap_planes.cuh"
#include "tex_resolve.cuh"

namespace {

#define F(x) ((float)(x))

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

__device__ __forceinline__ float as_f(uint32_t w) { return __uint_as_float(w); }

constexpr int kThreads = 128;

struct Args {
  const int* off;      // (tiles, G)
  const int* cnts;     // (tiles, cnt_cols)
  const int* staged;   // (tiles, budget * 4, 128)
  tap_planes::Plane rec, fx, fy, tl, attrs, flags, sel;  // (tiles, G|5|17|6|5, blocks, 128)
  int cnt_cols, budget, blocks;
  float* out;          // (tiles, 9, blocks, 128)
};

// kTri: both trilinear halves (groups s and 5 + s); kCasc: the cascade
// re-tap group n_groups - 5 + s where sel is set.
template <bool kTri, bool kCasc>
__global__ void __launch_bounds__(kThreads) resolve_shade_kernel(Args a) {
  constexpr int kGroups = 5 * ((kTri ? 2 : 1) + (kCasc ? 1 : 0));
  const int t = blockIdx.y, r = blockIdx.x, x = threadIdx.x;
  const size_t plane = (size_t)a.blocks * 128;
  const int* s_off = a.off + t * kGroups;
  const int* s_cnt = a.cnts + t * a.cnt_cols;
  const auto rec = tap_planes::row(a.rec, t, r);
  const auto fxr = tap_planes::row(a.fx, t, r);
  const auto fyr = tap_planes::row(a.fy, t, r);
  const auto tlr = tap_planes::row(a.tl, t, r);
  const auto attrs = tap_planes::row(a.attrs, t, r);
  const auto flags = tap_planes::row(a.flags, t, r);
  const auto selr = tap_planes::row(a.sel, t, r);
  auto attr = [&](int c) { return as_f(attrs(c, x)); };
  auto flag = [&](int c) { return flags(c, x) != 0; };

  const size_t px = (size_t)r * 128 + x;
  if (!flag(5)) {  // a background pixel: its output is 0, nothing else is read
#pragma unroll
    for (int c = 0; c < 9; ++c) a.out[((size_t)t * 9 + c) * plane + px] = 0.f;
    return;
  }

  // the slots the output reads: those whose map the material uses
  bool use[5], sel[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    use[s] = attr(12 + s) > 0.5f;
    sel[s] = kCasc && use[s] && selr(s, x) != 0;
  }

  // every tap's address and predicate, then every staged gather. A tap
  // that its slot does not read (an unused slot; under the cascade, the
  // re-tap where sel is clear, the lo and hi taps where it is set) reads
  // neither its record nor its fracs nor staged words, and blends to 0.
  const int* tile = a.staged + (size_t)t * a.budget * 4 * 128;
  bool need[kGroups];
  tex_resolve::TapAt at[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const bool re_tap = kCasc && g >= kGroups - 5;
    const int s = re_tap ? g - (kGroups - 5) : g % 5;
    need[g] = use[s] && (re_tap ? sel[s] : !sel[s]);
    at[g] = tex_resolve::tap_at(tile, a.budget, s_off[g], s_cnt[g],
                                need[g] ? (int)rec(g, x) : 0, need[g]);
  }
  int q[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) tex_resolve::tap_words(at[g], q[g]);

  // the blends: each slot's tap (both trilinear halves, or the cascade re-tap)
  auto tap = [&](int g, float rgba[4]) {
    tex_resolve::blend(q[g], need[g] ? as_f(fxr(g, x)) : 0.f,
                       need[g] ? as_f(fyr(g, x)) : 0.f, rgba);
  };
  float smp[5][4];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    tex_resolve::resolve_slot(tap, [&] { return use[s] ? as_f(tlr(s, x)) : 0.f; }, s, kGroups,
                              sel[s], kTri, smp[s]);
    if (use[s] && flag(s)) {  // the sRGB decode, of a slot the output reads
#pragma unroll
      for (int c = 0; c < 3; ++c) smp[s][c] = eotf(smp[s][c]);
    }
  }

  float nx = attr(0), ny = attr(1), nz = attr(2);
  float tx = attr(3), ty = attr(4), tz = attr(5);
  norm3(nx, ny, nz);
  norm3(tx, ty, tz);

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
  for (int c = 0; c < 9; ++c) a.out[((size_t)t * 9 + c) * plane + px] = q8(ch[c]);
}

}  // namespace

// Launch on `stream`; returns a CUDA error (0 = launched). planes: rec, fx,
// fy, tl, attrs, flags, sel (null without the cascade); strides: their
// (tile, group, row, lane) element strides, 4 each.
extern "C" int resolve_shade_launch(const int* off, const int* cnts, int cnt_cols,
                                    const int* staged, int budget, const void* const* planes,
                                    const long long* strides, int tiles, int n_groups,
                                    int blocks, int trilinear, float* out, void* stream) {
  const bool casc = planes[6] != nullptr;
  if (tiles < 1 || tiles > 65535 || blocks < 1 || cnt_cols < n_groups ||
      n_groups != 5 * ((trilinear ? 2 : 1) + (casc ? 1 : 0))) {
    return (int)cudaErrorInvalidValue;
  }
  tap_planes::Plane pl[7];
  tap_planes::planes_from(planes, strides, 7, pl);
  const Args a{off, cnts, staged, pl[0], pl[1], pl[2], pl[3], pl[4], pl[5], pl[6],
               cnt_cols, budget, blocks, out};
  const dim3 grid(blocks, tiles);
  const cudaStream_t st = (cudaStream_t)stream;
  if (trilinear && casc) resolve_shade_kernel<true, true><<<grid, kThreads, 0, st>>>(a);
  if (trilinear && !casc) resolve_shade_kernel<true, false><<<grid, kThreads, 0, st>>>(a);
  if (!trilinear && casc) resolve_shade_kernel<false, true><<<grid, kThreads, 0, st>>>(a);
  if (!trilinear && !casc) resolve_shade_kernel<false, false><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
