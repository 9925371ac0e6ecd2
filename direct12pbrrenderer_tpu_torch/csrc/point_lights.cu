// Tile-clustered point lights (the 1024-light operating point), kernel G.
//
// Replaces the TPU kernel direct12pbrrenderer_tpu/ops/lights_pallas.py
// _kernel (:138; point_lights_tiled :331 launches it through the pallas_call
// at :411): per screen tile, accumulate the Cook-Torrance contribution of the
// tile's listed lights (ops/lights_cuda.py tile_light_lists) with the
// per-cluster cap of 32 (deferred_shading.hlsl:158-186). Output (tiles, p, 4):
// [rgb * mask, cluster-hit counter].
//
// Semantics kept (ops/lights_cuda.py has the plain version):
//   * a pixel admits the first 32 lights of its tile's list (list order,
//     ascending light index) whose culling sphere meets its cluster AABB. The
//     TPU kernel decides each 128-light chunk at once with an exclusive lane
//     prefix sum of the raw hits (a strictly lower-triangular matmul); taking
//     the first 32 hits of the list admits the same lights;
//   * the contributions of each 128-entry chunk of the list are summed first
//     and then added to the running sums, as the TPU kernel adds one lane-sum
//     per chunk;
//   * the TPU kernel's formulas in its association order, every product and
//     sum rounded separately (--fmad=false); logf/powf/sqrtf at full
//     precision (a one-ulp change in log can move a pixel's cluster slice, so
//     the kernel is held to a tolerance against the plain version).
//
// What bounds it on an H100, and the design. The TPU kernel, on 128-lane
// grids, tests every listed light against every pixel: 7.2e8 sphere tests on
// the 1080p lights1k frame (428 listed lights per tile at p50), of which 5.8%
// admit a light, and the Cook-Torrance body runs under a divergent branch.
// But the test depends on the pixel only through its cluster (sx, sy, szf):
// the AABB is a function of those three and the constants, so every pixel of
// a cluster admits the same lights. So the kernel builds one admitted list
// per distinct cluster of each warp (`__match_any_sync` on the packed key; a
// warp holds 1-4 keys at 1080p, up to 32 at any size): the warp walks the
// tile's list 32 positions a step, one lane per light against the cluster's
// AABB (broadcast from the cluster's first lane), orders the hits with
// `__ballot_sync` + `__popc`, keeps the first 32 as list positions (uint16,
// in shared memory) and stops at the 32nd. The sphere-test columns of the
// list are staged in shared memory, 1024 positions at a time. Then each
// pixel walks only its cluster's admitted positions, reading the light
// columns through the read-only cache, and flushes its chunk sum whenever a
// position crosses a 128-entry boundary: the sums associate as before, and
// the hit counters are the same float decisions on the same values. A pixel
// with mask 0 skips the shading walk (its rgb is 0, its counter written).
// What bounds it then is the operations: about 100 of setup per pixel, 18
// per walked (cluster, position) and 100 per admitted light, against 177 MB
// of G-buffer, light rows and output at 1080p.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#define F(x) ((float)(x))

constexpr int kChunk = 128;     // the TPU kernel's lane width: chunk sums flush here
constexpr int kRow = 16;
constexpr int kGb = 12;
constexpr int kConst = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 1024;   // list positions whose test columns are staged at once
constexpr int kMaxHits = 32;    // lights admitted per cluster
constexpr int kClusterX = 24, kClusterY = 16, kClusterZ = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* counts;     // (tiles,) listed lights, clamped to cap
  const float* cst;      // (32,)
  const float* rows;     // (tiles, 16, cap)
  const float* gb;       // (tiles, p, 12), 16-byte aligned
  float* out;            // (tiles, p, 4)
  int cap, tile_h, tile_w, tiles_x;
};

// NaN-propagating clamp and max (jnp.clip / jnp.maximum semantics)
__device__ __forceinline__ float maxf(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float minf(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return minf(maxf(x, lo), hi); }

__global__ void __launch_bounds__(kThreads) point_lights_kernel(Args a) {
  __shared__ float s_cst[kConst];
  __shared__ float s_test[4 * kWindow];                // columns 10..13 of the window
  __shared__ uint16_t s_list[kWarps][32][kMaxHits];    // per warp, by cluster leader lane
  const int t = blockIdx.y;
  const int p = a.tile_h * a.tile_w;
  const int lin = blockIdx.x * kThreads + threadIdx.x;
  const bool live = lin < p;
  const int pix = live ? lin : p - 1;   // idle threads still take part in the warp's walks
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x < kConst) s_cst[threadIdx.x] = a.cst[threadIdx.x];
  __syncthreads();
  const float tan_half = s_cst[0], ratio = s_cst[1], near = s_cst[2], far = s_cst[3];
  const float camx = s_cst[4], camy = s_cst[5], camz = s_cst[6];
  const float yoff = s_cst[7], width = s_cst[17], full_h = s_cst[18];
  const float log_zr = s_cst[19], fn_ratio = s_cst[20];

  const float4* g4 = reinterpret_cast<const float4*>(a.gb) + ((size_t)t * p + pix) * 3;
  const float4 g0 = g4[0], g1 = g4[1], g2 = g4[2];
  const float alb[3] = {g0.x, g0.y, g0.z};
  const float nx = g0.w, ny = g1.x, nz = g1.y;
  const float rough = g1.z, metal = g1.w, z_view = g2.x;
  const float maskf = g2.y > 0.5f ? 1.f : 0.f;

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

  // per-pixel cluster AABB (view space, closed form): a function of
  // (sx, sy, szf) and the constants alone
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

  // ---- the admitted list of each distinct cluster of the warp ------------
  // The key holds szf's bits (a NaN slice admits nothing, whatever its
  // payload), so equal keys give bit-equal AABBs.
  const unsigned long long key = ((unsigned long long)__float_as_uint(szf) << 32) |
                                 ((unsigned)sx << 8) | (unsigned)sy;
  const int leader = __ffs(__match_any_sync(kFull, key)) - 1;
  const unsigned leaders = __ballot_sync(kFull, leader == lane);
  const unsigned below = (1u << lane) - 1u;
  const int count = min(a.counts[t], a.cap);
  const float* rows = a.rows + (size_t)t * kRow * a.cap;
  int n_adm = 0;   // admitted lights of this lane's cluster
  for (int w0 = 0; w0 < count; w0 += kWindow) {
    const int nw = min(kWindow, count - w0);
    const int nw32 = (nw + 31) & ~31;   // <= cap - w0: the cap is a multiple of 128
    __syncthreads();  // the previous window's columns are no longer read
    for (int i = threadIdx.x; i < 4 * nw32; i += kThreads) {
      const int c = i / nw32, l = i - c * nw32;
      s_test[c * kWindow + l] = rows[(size_t)(10 + c) * a.cap + w0 + l];
    }
    __syncthreads();
    for (unsigned todo = leaders; todo; todo &= todo - 1) {
      const int ld = __ffs(todo) - 1;
      int cnt = __shfl_sync(kFull, n_adm, ld);
      if (cnt >= kMaxHits) continue;
      const float bminx = __shfl_sync(kFull, cminx, ld), bmaxx = __shfl_sync(kFull, cmaxx, ld);
      const float bminy = __shfl_sync(kFull, cminy, ld), bmaxy = __shfl_sync(kFull, cmaxy, ld);
      const float bz0 = __shfl_sync(kFull, znear_c, ld), bz1 = __shfl_sync(kFull, zfar_c, ld);
      for (int b = 0; b < nw && cnt < kMaxHits; b += 32) {
        const int l = b + lane;
        const float pvx = s_test[l], pvy = s_test[kWindow + l];
        const float pvz = s_test[2 * kWindow + l], cull = s_test[3 * kWindow + l];
        const float dx = pvx - clampf(pvx, bminx, bmaxx);
        const float dy = pvy - clampf(pvy, bminy, bmaxy);
        const float dz = pvz - clampf(pvz, bz0, bz1);
        const bool hit = l < nw && (dx * dx + dy * dy + dz * dz) < cull * cull;
        const unsigned ballot = __ballot_sync(kFull, hit);
        const int slot = cnt + __popc(ballot & below);
        if (hit && slot < kMaxHits) s_list[warp][ld][slot] = (uint16_t)(w0 + l);
        cnt = min(kMaxHits, cnt + __popc(ballot));
      }
      if (leader == ld) n_adm = cnt;
    }
  }
  __syncwarp();

  // ---- shading: only the admitted lights, in list order ------------------
  const uint16_t* adm = s_list[warp][leader];
  const int n_shade = maskf != 0.f ? n_adm : 0;
  float acc[3] = {0.f, 0.f, 0.f}, part[3] = {0.f, 0.f, 0.f};
  int chunk = -1;
  for (int k = 0; k < n_shade; ++k) {
    const int l = adm[k];
    if (l / kChunk != chunk) {  // the chunk sum so far joins the running sums
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc[c] = acc[c] + part[c];
        part[c] = 0.f;
      }
      chunk = l / kChunk;
    }
    const float* lr = rows + l;
    auto col = [&](int j) { return __ldg(lr + (size_t)j * a.cap); };
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

  if (live) {
    float4 o = make_float4(acc[0] * maskf, acc[1] * maskf, acc[2] * maskf, (float)n_adm);
    reinterpret_cast<float4*>(a.out)[(size_t)t * p + pix] = o;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int point_lights_launch(const int* counts, const float* cst, const float* rows,
                                   const float* gb, int tiles, int cap, int tile_h, int tile_w,
                                   int tiles_x, float* out, void* stream) {
  const int p = tile_h * tile_w;
  // list positions ride as uint16; gb is read as float4
  if (tiles < 1 || tiles > 65535 || cap < kChunk || cap % kChunk || cap > 65536 || p < 1 ||
      tiles_x < 1 || reinterpret_cast<uintptr_t>(gb) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{counts, cst, rows, gb, out, cap, tile_h, tile_w, tiles_x};
  point_lights_kernel<<<dim3((p + kThreads - 1) / kThreads, tiles), kThreads, 0,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
