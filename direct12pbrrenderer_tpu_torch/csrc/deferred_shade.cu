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
// What bounds it on an H100: the light loop, about 60 flops per pixel and
// active light plus a few transcendentals, about 1 GFLOP per 8-light 1080p
// frame; memory is 14 + 3 x G in, 5 x 8 staged words and 4 out per pixel,
// about 0.4 GB. Design: one thread per pixel, one block per 128-pixel tile
// row; the active-light rows (at most 64 x 14 floats) and the const vector
// sit in shared memory, read by every thread at once (a broadcast); the
// accumulators stay in registers for the whole loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_resolve.cuh"

namespace {

#define F(x) ((float)(x))

constexpr int kMaxLights = 64;
constexpr int kConst = 64;
constexpr int kClusterX = 24, kClusterY = 16, kClusterZ = 8;
constexpr float kMaxPerCluster = 32.f;

struct Args {
  const float* cst;      // (64,)
  const float* lights;   // (light_pool, 14)
  const int* off;        // (tiles, G)
  const int* cnts;       // (tiles, G)
  const int* staged;     // (tiles, B * 8, 128)
  const int* rec;        // (tiles, G, blocks, 128)
  const float* fx;
  const float* fy;
  const float* gb;       // (tiles, 14, blocks, 128)
  float* out;            // (tiles, 4, blocks, 128)
  int light_pool, budget, n_groups, blocks, has_env, tile_h, tile_w, tiles_x;
};

// NaN-propagating clamp and max (jnp.clip / jnp.maximum semantics)
__device__ __forceinline__ float maxf(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float minf(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return minf(maxf(x, lo), hi); }

__device__ void resolve_env(const Args& a, int t, size_t pix, int gi, float rgba[4]) {
  const size_t at = ((size_t)t * a.n_groups + gi) * a.blocks * 128 + pix;
  resolve_env_tap(a.staged + (size_t)t * a.budget * 8 * 128, a.budget,
                  a.off[t * a.n_groups + gi], a.cnts[t * a.n_groups + gi], a.rec[at], a.fx[at],
                  a.fy[at], rgba);
}

__global__ void deferred_shade_kernel(Args a) {
  __shared__ float s_cst[kConst];
  __shared__ float s_lt[kMaxLights * 14];
  const int t = blockIdx.y;
  const int bidx = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t plane = (size_t)a.blocks * 128;
  const size_t pix = (size_t)bidx * 128 + lane;

  for (int i = threadIdx.x; i < kConst; i += blockDim.x) s_cst[i] = a.cst[i];
  __syncthreads();
  const int n_active = min((int)s_cst[21], a.light_pool);
  for (int i = threadIdx.x; i < n_active * 14; i += blockDim.x) s_lt[i] = a.lights[i];
  __syncthreads();

  float res[5][4];  // group 4 (the cascade) exists only with env content
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    if (g < a.n_groups) {
      resolve_env(a, t, pix, g, res[g]);
    } else {
      res[g][0] = res[g][1] = res[g][2] = res[g][3] = 0.f;
    }
  }

  auto gch = [&](int c) { return a.gb[((size_t)t * 14 + c) * plane + pix]; };
  float alb[3] = {gch(0), gch(1), gch(2)};
  const float emission = gch(3);
  const float nx = gch(4), ny = gch(5), nz = gch(6);
  const float rough = gch(7), metal = gch(8);
  const float z_view = gch(9);
  const bool mask = gch(10) > 0.5f;
  const float fracm = gch(11);
  const bool cov0 = gch(12) > 0.5f;
  const bool cov4 = gch(13) > 0.5f;

  // ---- environment specular: split-sum (deferred_shading.hlsl:56-70) ----
  const float one_m_frac = 1.f - fracm;
  float f0[3], env_spec[3], env_diff[3], kd_alb[3];
  for (int c = 0; c < 3; ++c) {
    const float exact = res[0][c] * one_m_frac + res[1][c] * fracm;
    const float fb = a.has_env ? (cov4 ? res[4][c] : res[0][c]) : res[0][c];
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
  const float row = (float)(bidx / wb);
  const float col = (float)((bidx % wb) * 128 + lane);
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
  const float znear_c = near * powf(fn_ratio, szf / (float)kClusterZ);
  const float zfar_c = near * powf(fn_ratio, (szf + 1.f) / (float)kClusterZ);
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

  // ---- clustered point lights (hlsl:158-186) ------------------------------
  float acc[3] = {0.f, 0.f, 0.f};
  float counter = 0.f;
  for (int s = 0; s < n_active; ++s) {
    const float* lp = s_lt + s * 14;
    const float dx = lp[10] - clampf(lp[10], cminx, cmaxx);
    const float dy = lp[11] - clampf(lp[11], cminy, cmaxy);
    const float dz = lp[12] - clampf(lp[12], znear_c, zfar_c);
    const bool hit = (dx * dx + dy * dy + dz * dz) < lp[13] * lp[13] && counter < kMaxPerCluster;
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
      counter = counter + 1.f;
    }
  }

  // ---- final = env_diffuse + env_specular + point + emission | sky -------
  for (int c = 0; c < 3; ++c) {
    const float lit = env_diff[c] + env_spec[c] + acc[c] + alb[c] * emission;
    a.out[((size_t)t * 4 + c) * plane + pix] = mask ? lit : res[3][c];
  }
  a.out[((size_t)t * 4 + 3) * plane + pix] = counter;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int deferred_shade_launch(const float* cst, const float* lights, int light_pool,
                                     const int* off, const int* cnts, const int* staged,
                                     int budget, const int* rec, const float* fx,
                                     const float* fy, const float* gb, int tiles, int n_groups,
                                     int blocks, int has_env, int tile_h, int tile_w,
                                     int tiles_x, float* out, void* stream) {
  if (light_pool < 1 || light_pool > kMaxLights || n_groups < 4 || n_groups > 5 ||
      tile_w % 128 || blocks * 128 != tile_h * tile_w) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{cst, lights, off, cnts, staged, rec, fx, fy, gb, out,
         light_pool, budget, n_groups, blocks, has_env, tile_h, tile_w, tiles_x};
  deferred_shade_kernel<<<dim3(blocks, tiles), 128, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
