// Device code shared by the render kernels (mega_render.cu, tile_kernels.cu):
// the constants of the candidate chunks and the sphere root of the chunk
// walk.  Each kernel keeps its own shadow walks and block-wide max.
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

}  // namespace render
