// Fused deferred shading on the G-buffer's tile blocks.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/shade_pallas.py
// _deferred_kernel (with envcache._resolve_env_group): per pixel, resolve the
// env-cache tap groups (prefiltered env trilinear halves, BRDF LUT, sky, and
// the mip+3 cascade when env content exists) against the tile's staged bf16
// pages, then SH2 irradiance diffuse + split-sum specular + the clustered
// point-light loop + emission, or the sky on background pixels
// (deferred_shading.hlsl:23-186, skybox.hlsl). Output (tiles, 4, blocks, 128):
// [rgb, cluster-hit counter].
//
// Semantics kept (ops/shade_fused.py has the plain version):
//   * a tap reads the 8 packed words at staged[t, (off + seg) * 8 + k, rec &
//     127]; a segment at or beyond ceil8(cnt) resolves to 0. Value v of the
//     quad is the bf16 in word v >> 1: low half << 16, high half & ~0xFFFF,
//     bit cast to float (envcache.py:274-277). The tap body is
//     env_resolve.cuh, shared with kernel F (env_resolve.cu);
//   * the light loop walks the frame's active rows in order with a per-pixel
//     hit counter below 32 (MAX_LIGHTS_PER_CLUSTER): serial, so the cap is
//     exact. A light's contribution is masked with a select (the TPU kernel's
//     0/1 multiply would let a NaN of a degenerate row through; on finite
//     values the two agree exactly);
//   * the TPU kernel's formulas in its association order, every product and
//     sum rounded separately (--fmad=false); logf/powf/sqrtf at full
//     precision (a one-ulp change in log can move a pixel's cluster slice,
//     which is why this kernel is held to a tolerance, not to bit-equality).
//
// What bounds it on an H100: bytes, 14 + 3 x G planar words in, up to 8
// staged words per tap and 4 words out per pixel; the light loop is about
// 60 flops per pixel and active light plus a few transcendentals. What kept
// a kernel from that: every pixel resolved all G groups (40 gathered words)
// and evaluated every light's body, though a background pixel reads only the
// sky group and discards the light sums. This design:
//   * reads every plane in place through its strides (tap_planes.cuh); one
//     thread per pixel, one block per 128-pixel tile row;
//   * a pixel resolves only the groups whose result it may read: the sky
//     (group 3) on a background pixel, groups 0, 1, 2 and 4 on a lit one;
//     it reads those taps' records and fracs only, computes their
//     addresses first, issues all their loads, then blends;
//   * each light's cheap cluster-sphere test comes first; its Cook-Torrance
//     body is evaluated only when some lit lane of the warp hits it, and
//     each lane still adds under its own hit, in the same order, so the rgb
//     and the hit counter are those of the full loop;
//   * the 9 values powf(far/near, k / 8) of the cluster slices are computed
//     once per block from the same expressions, and a pixel looks up its
//     slice's two;
//   * the active-light rows (at most 64 x 14 floats) and the const vector
//     sit in shared memory, read by every thread at once (a broadcast).

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_resolve.cuh"
#include "tap_planes.cuh"

namespace {

#define F(x) ((float)(x))

constexpr int kMaxLights = 64;
constexpr int kConst = 64;
constexpr int kClusterX = 24, kClusterY = 16, kClusterZ = 8;
constexpr float kMaxPerCluster = 32.f;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* cst;      // (64,)
  const float* lights;   // (light_pool, 14)
  const int* off;        // (tiles, G)
  const int* cnts;       // (tiles, G)
  const int* staged;     // (tiles, B * 8, 128)
  tap_planes::Plane rec, fx, fy, gb;  // (tiles, G|G|G|14, blocks, 128)
  float* out;            // (tiles, 4, blocks, 128)
  int light_pool, budget, blocks, tile_h, tile_w, tiles_x;
};

// NaN-propagating clamp and max (jnp.clip / jnp.maximum semantics)
__device__ __forceinline__ float maxf(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float minf(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return minf(maxf(x, lo), hi); }

template <int kGroups>  // 4, or 5 with env content (the cascade group 4)
__global__ void __launch_bounds__(kThreads) deferred_shade_kernel(Args a) {
  __shared__ float s_cst[kConst];
  __shared__ float s_lt[kMaxLights * 14];
  __shared__ float s_zpow[kClusterZ + 1];
  constexpr bool has_env = kGroups == 5;
  const int t = blockIdx.y, r = blockIdx.x, x = threadIdx.x;
  const size_t plane = (size_t)a.blocks * 128;

  for (int i = threadIdx.x; i < kConst; i += blockDim.x) s_cst[i] = a.cst[i];
  __syncthreads();
  const int n_active = min((int)s_cst[21], a.light_pool);
  for (int i = threadIdx.x; i < n_active * 14; i += blockDim.x) s_lt[i] = a.lights[i];
  // the cluster slices' depth powers, as the per-pixel expressions give them
  if (threadIdx.x <= kClusterZ) {
    s_zpow[threadIdx.x] = powf(s_cst[20], (float)threadIdx.x / (float)kClusterZ);
  }
  __syncthreads();

  const int* s_off = a.off + t * kGroups;
  const int* s_cnt = a.cnts + t * kGroups;
  const auto rec = tap_planes::row(a.rec, t, r);
  const auto fxr = tap_planes::row(a.fx, t, r);
  const auto fyr = tap_planes::row(a.fy, t, r);
  const auto gbr = tap_planes::row(a.gb, t, r);
  auto gch = [&](int c) { return __uint_as_float(gbr(c, x)); };
  const bool mask = gch(10) > 0.5f;

  // the taps this pixel reads: the sky (group 3) on a background pixel,
  // the others on a lit one. Their addresses, then every load, then the
  // blends; a tap it does not read reads neither its record, its fracs nor
  // staged words, and is 0. (A lit pixel's output reads only 2 or 3 of its
  // 4 taps, as its coverage flags select; skipping the unread ones too
  // measured slower, PERF.md.)
  bool need[kGroups];
  const int* tile = a.staged + (size_t)t * a.budget * 8 * 128;
  EnvTapAt at[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    need[g] = g == 3 ? !mask : mask;
    at[g] = env_tap_at(tile, a.budget, s_off[g], s_cnt[g], need[g] ? (int)rec(g, x) : 0,
                       need[g]);
  }
  unsigned w[kGroups][8];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) env_tap_words(at[g], w[g]);
  float res[5][4];  // group 4 (the cascade) exists only with env content
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    if (g < kGroups) {
      env_tap_blend(w[g], need[g] ? __uint_as_float(fxr(g, x)) : 0.f,
                    need[g] ? __uint_as_float(fyr(g, x)) : 0.f, res[g]);
    } else {
      res[g][0] = res[g][1] = res[g][2] = res[g][3] = 0.f;
    }
  }

  float alb[3] = {gch(0), gch(1), gch(2)};
  const float emission = gch(3);
  const float nx = gch(4), ny = gch(5), nz = gch(6);
  const float rough = gch(7), metal = gch(8);
  const float z_view = gch(9);
  const float fracm = gch(11);
  const bool cov0 = gch(12) > 0.5f;
  const bool cov4 = gch(13) > 0.5f;

  // ---- environment specular: split-sum (deferred_shading.hlsl:56-70) ----
  const float one_m_frac = 1.f - fracm;
  float f0[3], env_spec[3], env_diff[3], kd_alb[3];
  for (int c = 0; c < 3; ++c) {
    const float exact = res[0][c] * one_m_frac + res[1][c] * fracm;
    const float fb = has_env ? (cov4 ? res[4][c] : res[0][c]) : res[0][c];
    const float env_irr = cov0 ? exact : fb;
    f0[c] = F(0.04) * (1.f - metal) + alb[c] * metal;
    env_spec[c] = env_irr * (f0[c] * res[2][0] + res[2][1]);
  }

  // ---- environment diffuse: SH2 polynomial (hlsl:23-54) ------------------
  const float* sh = s_cst + 24;
  const float b0 = nx * ny, b1 = ny * nz, b2 = nz * nz, b3 = nz * nx;
  const float c1 = nx * nx - ny * ny;
  for (int c = 0; c < 3; ++c) {
    const int ra = 2 * c, rb = 2 * c + 1;
    const float av = nx * sh[4 * ra] + ny * sh[4 * ra + 1] + nz * sh[4 * ra + 2] + sh[4 * ra + 3];
    const float bv = b0 * sh[4 * rb] + b1 * sh[4 * rb + 1] + b2 * sh[4 * rb + 2] + b3 * sh[4 * rb + 3];
    const float irr = av + bv + sh[24 + c] * c1;
    kd_alb[c] = alb[c] * ((1.f - metal) * F(0.31830988618));
    env_diff[c] = kd_alb[c] * irr;
  }

  // ---- per-pixel position and view vector --------------------------------
  const float tan_half = s_cst[0], ratio = s_cst[1], near = s_cst[2], far = s_cst[3];
  const float camx = s_cst[4], camy = s_cst[5], camz = s_cst[6];
  const float yoff = s_cst[7], fw = s_cst[17], fh = s_cst[18];
  const float log_zr = s_cst[19], fn_ratio = s_cst[20];
  const int wb = a.tile_w / 128;
  const float row = (float)(r / wb);
  const float col = (float)((r % wb) * 128 + x);
  const float ox = (float)((t % a.tiles_x) * a.tile_w);
  const float oy = (float)((t / a.tiles_x) * a.tile_h);
  const float u = (col + 0.5f + ox) / fw;
  const float v = (row + 0.5f + oy + yoff) / fh;
  const float near_h = 2.f * near * tan_half;
  const float near_w = near_h * ratio;
  const float cx = (u - 0.5f) * near_w;
  const float cy = (0.5f - v) * near_h;
  const float scale = z_view / near;
  const float posx = camx + (s_cst[8] * cx + s_cst[9] * cy + s_cst[10] * near) * scale;
  const float posy = camy + (s_cst[11] * cx + s_cst[12] * cy + s_cst[13] * near) * scale;
  const float posz = camz + (s_cst[14] * cx + s_cst[15] * cy + s_cst[16] * near) * scale;
  float vdx = camx - posx, vdy = camy - posy, vdz = camz - posz;
  const float inv_vl = 1.f / sqrtf(maxf(vdx * vdx + vdy * vdy + vdz * vdz, F(1e-40)));
  vdx = vdx * inv_vl;
  vdy = vdy * inv_vl;
  vdz = vdz * inv_vl;
  const float n_dot_v = maxf(nx * vdx + ny * vdy + nz * vdz, 0.f);

  // ---- per-pixel cluster AABB (clustered_compute.hlsl:21-42) --------------
  const float sx = clampf(floorf(u * (float)kClusterX), 0.f, (float)(kClusterX - 1));
  const float sy = clampf(floorf((1.f - v) * (float)kClusterY), 0.f, (float)(kClusterY - 1));
  const float zc = clampf(z_view, near, far);
  const float szf = clampf(floorf((float)kClusterZ * logf(zc / near) / log_zr), 0.f,
                           (float)(kClusterZ - 1));
  float pz0, pz1;  // powf(fn_ratio, szf / 8) and powf(fn_ratio, (szf + 1) / 8)
  if (szf == szf) {
    pz0 = s_zpow[(int)szf];
    pz1 = s_zpow[(int)szf + 1];
  } else {
    pz0 = powf(fn_ratio, szf / (float)kClusterZ);
    pz1 = powf(fn_ratio, (szf + 1.f) / (float)kClusterZ);
  }
  const float znear_c = near * pz0;
  const float zfar_c = near * pz1;
  const float min_nx = 2.f * sx / (float)kClusterX - 1.f;
  const float min_ny = 2.f * sy / (float)kClusterY - 1.f;
  const float max_nx = 2.f * (sx + 1.f) / (float)kClusterX - 1.f;
  const float max_ny = 2.f * (sy + 1.f) / (float)kClusterY - 1.f;
  const float xa = min_nx * ratio * tan_half * znear_c, xb = min_nx * ratio * tan_half * zfar_c;
  const float xc = max_nx * ratio * tan_half * znear_c, xd = max_nx * ratio * tan_half * zfar_c;
  const float ya = min_ny * tan_half * znear_c, yb = min_ny * tan_half * zfar_c;
  const float yc = max_ny * tan_half * znear_c, yd = max_ny * tan_half * zfar_c;
  const float cminx = minf(minf(xa, xb), minf(xc, xd));
  const float cmaxx = maxf(maxf(xa, xb), maxf(xc, xd));
  const float cminy = minf(minf(ya, yb), minf(yc, yd));
  const float cmaxy = maxf(maxf(ya, yb), maxf(yc, yd));

  const float a2 = (rough * rough) * (rough * rough);
  const float k_geo = (rough + 1.f) * (rough + 1.f) * (1.f / 8.f);
  const float g_v = n_dot_v / maxf(n_dot_v * (1.f - k_geo) + k_geo, F(1e-6));

  // ---- clustered point lights (hlsl:158-186) ----------------------------
  // the sphere test first; the body only where a lit lane of the warp hits
  float acc[3] = {0.f, 0.f, 0.f};
  float counter = 0.f;
  for (int s = 0; s < n_active; ++s) {
    const float* lp = s_lt + s * 14;
    const float dx = lp[10] - clampf(lp[10], cminx, cmaxx);
    const float dy = lp[11] - clampf(lp[11], cminy, cmaxy);
    const float dz = lp[12] - clampf(lp[12], znear_c, zfar_c);
    const bool hit = (dx * dx + dy * dy + dz * dz) < lp[13] * lp[13] && counter < kMaxPerCluster;
    if (__any_sync(kFull, hit && mask)) {
      float ldx = lp[0] - posx, ldy = lp[1] - posy, ldz = lp[2] - posz;
      const float dist = sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
      const float inv_d = 1.f / maxf(dist, F(1e-20));
      ldx = ldx * inv_d;
      ldy = ldy * inv_d;
      ldz = ldz * inv_d;
      const float n_dot_l = maxf(nx * ldx + ny * ldy + nz * ldz, 0.f);
      const float hx = ldx + vdx, hy = ldy + vdy, hz = ldz + vdz;
      const float inv_h = 1.f / maxf(sqrtf(hx * hx + hy * hy + hz * hz), F(1e-6));
      const float n_dot_h = maxf((nx * hx + ny * hy + nz * hz) * inv_h, 0.f);
      const float t_ = n_dot_h * n_dot_h * (a2 - 1.f) + 1.f;
      const float d_ggx = a2 / maxf(F(3.14159265359) * t_ * t_, F(1e-6));
      const float g_l = n_dot_l / maxf(n_dot_l * (1.f - k_geo) + k_geo, F(1e-6));
      const float spec_s = d_ggx * (g_v * g_l) / maxf(4.f * n_dot_l * n_dot_v, F(1e-4));
      const float one_m = maxf(1.f - n_dot_l, F(1e-6));
      const float om2 = one_m * one_m;
      const float pow5 = om2 * om2 * one_m;
      const float att = 1.f / maxf(lp[7] + lp[8] * dist + lp[9] * (dist * dist), F(1e-6));
      const float lum = lp[6] * att * n_dot_l;
      if (hit) {
        for (int c = 0; c < 3; ++c) {
          const float fres = f0[c] + (1.f - f0[c]) * pow5;
          acc[c] = acc[c] + ((1.f - fres) * kd_alb[c] + fres * spec_s) * (lp[3 + c] * lum);
        }
      }
    }
    if (hit) counter = counter + 1.f;
  }

  // ---- final = env_diffuse + env_specular + point + emission | sky -----
  const size_t px = (size_t)r * 128 + x;
  for (int c = 0; c < 3; ++c) {
    const float lit = env_diff[c] + env_spec[c] + acc[c] + alb[c] * emission;
    a.out[((size_t)t * 4 + c) * plane + px] = mask ? lit : res[3][c];
  }
  a.out[((size_t)t * 4 + 3) * plane + px] = counter;
}

}  // namespace

// Launch on `stream`; returns a CUDA error (0 = launched). planes: rec, fx,
// fy, gb; strides: their (tile, group, row, lane) element strides, 4 each.
extern "C" int deferred_shade_launch(const float* cst, const float* lights, int light_pool,
                                     const int* off, const int* cnts, const int* staged,
                                     int budget, const void* const* planes,
                                     const long long* strides, int tiles, int n_groups,
                                     int blocks, int has_env, int tile_h, int tile_w,
                                     int tiles_x, float* out, void* stream) {
  if (light_pool < 1 || light_pool > kMaxLights || n_groups != 4 + (has_env != 0) ||
      tile_w % 128 || blocks * 128 != tile_h * tile_w || tiles < 1 || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  tap_planes::Plane pl[4];
  tap_planes::planes_from(planes, strides, 4, pl);
  const Args a{cst, lights, off, cnts, staged, pl[0], pl[1], pl[2], pl[3], out,
               light_pool, budget, blocks, tile_h, tile_w, tiles_x};
  const dim3 grid(blocks, tiles);
  const cudaStream_t st = (cudaStream_t)stream;
  if (has_env) {
    deferred_shade_kernel<5><<<grid, kThreads, 0, st>>>(a);
  } else {
    deferred_shade_kernel<4><<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
