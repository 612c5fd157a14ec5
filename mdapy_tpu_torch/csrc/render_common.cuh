// Device code shared by the render kernels (mega_render.cu, tile_kernels.cu):
// the constants of the candidate chunks, the sphere root of the chunk walk,
// the serial walk over one light-grid cell's shadow records (the shadow
// filter's; mega_render.cu queues its walks and keeps its own), and a
// block-wide max.
// Every translation unit is compiled with -fmad=false, so a*b+c rounds twice
// here as in the plain torch versions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace render {

constexpr int CH = 128;          // candidates per chunk
constexpr float BIG = 1e18f;
constexpr float BIG_DEPTH = 1e17f;

// Nearest t > eps of a unit-direction ray against a sphere, from b = oc.d (oc
// = ray origin - centre) and the discriminant disc = b^2 - (|oc|^2 - r^2),
// which the caller has found >= 0; BIG when both roots lie at or behind eps.
// The caller branches on disc itself, so that the many candidates a ray
// misses cost no square root.  A dead slot is given |oc|^2 - r^2 = +inf, so
// its discriminant is negative.
__device__ __forceinline__ float sphere_root(float b, float disc, float eps) {
  const float sq = sqrtf(disc);
  const float t1 = -b - sq;
  const float t2 = sq - b;
  return t1 > eps ? t1 : (t2 > eps ? t2 : BIG);
}

// True when one of the cnt shadow records at rp blocks the point with
// light-space coordinates (u, v) and depth tau (tau_eps = tau + eps).  A
// record is two float4: [cu, cv, ck, r] and [key, alpha, 0, 0].  The records
// run by descending far key, so the walk stops at the first occluder or once
// key <= tau + eps, after which no record can occlude.
__device__ __forceinline__ bool walk_cell(const float4* __restrict__ rp,
                                          int cnt, float u, float v,
                                          float tau_eps) {
  for (int i = 0; i < cnt; ++i) {
    const float4 a = rp[2 * i];      // cu, cv, ck, r
    const float key = rp[2 * i + 1].x;
    if (key <= tau_eps) return false;
    const float du = a.x - u, dv = a.y - v;
    const float s2 = a.w * a.w - (du * du + dv * dv);
    const float q = tau_eps - a.z;
    if (s2 > 0.0f && a.w > 0.0f && (q < 0.0f || s2 > q * q)) return true;
  }
  return false;
}

// Block-wide max over NT threads (a multiple of 32); every thread gets the
// result.  red holds NT / 32 floats.
template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}

}  // namespace render
