// Tile-clustered point lights (the 1024-light operating point).
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/lights_pallas.py
// _kernel: per screen tile, accumulate the Cook-Torrance contribution of the
// tile's listed lights (ops/lights_cuda.py tile_light_lists) with the
// per-cluster cap of 32 (deferred_shading.hlsl:158-186). Output (tiles, p, 4):
// [rgb * mask, cluster-hit counter].
//
// Semantics kept (ops/lights_cuda.py has the plain version):
//   * the light rows are walked in list order (ascending light index) in
//     chunks of 128; a light is admitted when its culling sphere meets the
//     pixel's cluster AABB and the pixel's running hit counter is below 32.
//     The TPU kernel decides the whole chunk at once with an exclusive lane
//     prefix sum of the raw hits (a strictly lower-triangular matmul); a
//     serial walk with the counter admits the same lights;
//   * each chunk's contributions are summed first and then added to the
//     running sums, as the TPU kernel adds one lane-sum per chunk;
//   * the TPU kernel's formulas in its association order, every product and
//     sum rounded separately (--fmad=false); logf/powf/sqrtf at full
//     precision (a one-ulp change in log can move a pixel's cluster slice, so
//     the kernel is held to a tolerance against the plain version).
//
// What bounds it on an H100: the light loop, about 18 flops per pixel and
// listed light for the cluster sphere test, and about 100 more (with a sqrt
// and three divisions) for each admitted light, at most 32 per pixel; memory
// is 12 floats in and 4 out per pixel (133 MB at 1080p). Design: one thread per
// pixel, one block per 256 pixels of a tile; the tile's light rows stream
// through shared memory in 128-light chunks (16 x 128 floats = 8 KB; the
// whole list at cap 1024 would be 64 KB, above the 48 KB static limit); the
// trip count min(count, cap) is read on the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#define F(x) ((float)(x))

constexpr int kChunk = 128;
constexpr int kRow = 16;
constexpr int kGb = 12;
constexpr int kConst = 32;
constexpr int kThreads = 256;
constexpr int kClusterX = 24, kClusterY = 16, kClusterZ = 8;
constexpr float kMaxPerCluster = 32.f;

struct Args {
  const int* counts;     // (tiles,) listed lights, clamped to cap
  const float* cst;      // (32,)
  const float* rows;     // (tiles, 16, cap)
  const float* gb;       // (tiles, p, 12)
  float* out;            // (tiles, p, 4)
  int cap, tile_h, tile_w, tiles_x;
};

// NaN-propagating clamp and max (jnp.clip / jnp.maximum semantics)
__device__ __forceinline__ float maxf(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float minf(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return minf(maxf(x, lo), hi); }

__global__ void __launch_bounds__(kThreads) point_lights_kernel(Args a) {
  __shared__ float s_cst[kConst];
  __shared__ float s_rows[kRow * kChunk];
  const int t = blockIdx.y;
  const int p = a.tile_h * a.tile_w;
  const int lin = blockIdx.x * kThreads + threadIdx.x;
  const bool live = lin < p;
  const int pix = live ? lin : p - 1;   // idle threads still help stage the rows

  if (threadIdx.x < kConst) s_cst[threadIdx.x] = a.cst[threadIdx.x];
  __syncthreads();
  const float tan_half = s_cst[0], ratio = s_cst[1], near = s_cst[2], far = s_cst[3];
  const float camx = s_cst[4], camy = s_cst[5], camz = s_cst[6];
  const float yoff = s_cst[7], width = s_cst[17], full_h = s_cst[18];
  const float log_zr = s_cst[19], fn_ratio = s_cst[20];

  const float* g = a.gb + ((size_t)t * p + pix) * kGb;
  const float alb[3] = {g[0], g[1], g[2]};
  const float nx = g[3], ny = g[4], nz = g[5];
  const float rough = g[6], metal = g[7], z_view = g[8];
  const float maskf = g[9] > 0.5f ? 1.f : 0.f;

  // world position: cam + R @ ((u-.5)nw, (.5-v)nh, near) * z_view/near
  const int ox = (t % a.tiles_x) * a.tile_w;
  const int oy = (t / a.tiles_x) * a.tile_h;
  const float px = (float)(pix % a.tile_w) + 0.5f + (float)ox;
  const float py = (float)(pix / a.tile_w) + 0.5f + (float)oy + yoff;
  const float u = px / width;
  const float v = py / full_h;
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

  // per-pixel cluster AABB (view space, closed form)
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

  // material precomputes
  float f0[3], kd_alb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f0[c] = F(0.04) * (1.f - metal) + alb[c] * metal;
    kd_alb[c] = alb[c] * (1.f - metal) * F(0.31830988618);
  }
  const float a_r = rough * rough;
  const float a2 = a_r * a_r;
  const float k_geo = (rough + 1.f) * (rough + 1.f) * (1.f / 8.f);
  const float g_v = n_dot_v / maxf(n_dot_v * (1.f - k_geo) + k_geo, F(1e-6));

  const int count = min(a.counts[t], a.cap);
  const float* rows = a.rows + (size_t)t * kRow * a.cap;
  float acc[3] = {0.f, 0.f, 0.f};
  float counter = 0.f;
  for (int base = 0; base < count; base += kChunk) {
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int i = threadIdx.x; i < kRow * kChunk; i += kThreads) {
      s_rows[i] = rows[(size_t)(i / kChunk) * a.cap + base + i % kChunk];
    }
    __syncthreads();
    const int n = min(kChunk, count - base);
    float part[3] = {0.f, 0.f, 0.f};
    float hits = 0.f;
    for (int l = 0; l < n; ++l) {
      auto col = [&](int j) { return s_rows[j * kChunk + l]; };
      const float pvx = col(10), pvy = col(11), pvz = col(12), cull = col(13);
      const float dx = pvx - clampf(pvx, cminx, cmaxx);
      const float dy = pvy - clampf(pvy, cminy, cmaxy);
      const float dz = pvz - clampf(pvz, znear_c, zfar_c);
      if (!((dx * dx + dy * dy + dz * dz) < cull * cull) || !(counter + hits < kMaxPerCluster)) {
        continue;
      }
      hits = hits + 1.f;
      float ldx = col(0) - posx, ldy = col(1) - posy, ldz = col(2) - posz;
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
      const float g_smith = g_v * g_l;
      const float spec_s = d_ggx * g_smith / maxf(4.f * n_dot_l * n_dot_v, F(1e-4));
      const float one_m = maxf(1.f - n_dot_l, F(1e-6));
      const float om2 = one_m * one_m;
      const float pow5 = om2 * om2 * one_m;
      const float att = 1.f / maxf(col(7) + col(8) * dist + col(9) * (dist * dist), F(1e-6));
      const float lum = col(6) * att * n_dot_l;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float fres = f0[c] + (1.f - f0[c]) * pow5;
        const float f_c = (1.f - fres) * kd_alb[c] + fres * spec_s;
        part[c] = part[c] + f_c * (col(3 + c) * lum);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + part[c];
    counter = counter + hits;
  }

  if (live) {
    float4 o = make_float4(acc[0] * maskf, acc[1] * maskf, acc[2] * maskf, counter);
    reinterpret_cast<float4*>(a.out)[(size_t)t * p + pix] = o;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int point_lights_launch(const int* counts, const float* cst, const float* rows,
                                   const float* gb, int tiles, int cap, int tile_h, int tile_w,
                                   int tiles_x, float* out, void* stream) {
  const int p = tile_h * tile_w;
  if (tiles < 1 || cap < kChunk || cap % kChunk || p < 1 || tiles_x < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{counts, cst, rows, gb, out, cap, tile_h, tile_w, tiles_x};
  point_lights_kernel<<<dim3((p + kThreads - 1) / kThreads, tiles), kThreads, 0,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
