// Hand CUDA kernels of the tiled tracer: the chunked sphere closest hit and
// the light-grid shadow filter.
//
// closest_hit_kernel replaces the Pallas TPU kernel
// mdapy_tpu/render/pallas_kernels.py:_kernel (launched at :459 by
// closest_hit_spheres_tiles); shadow_filter_kernel replaces
// pallas_kernels.py:_shadow_kernel (launched at :403 by shadow_filter_tiles).
// They compute what those kernels compute; neither is a block-by-block
// translation.
//
// Closest hit.  The rays of a tile arrive from device memory (the caller
// generated them), up to SLICE = 2,048 of them per block: a tile with more
// rays is cut into equal slices, one block each, as the TPU wrapper cuts its
// ray blocks.  A thread holds up to RPT = 8 rays in registers.  The block
// walks the tile's depth-sorted 128-wide candidate chunks front to back: it
// stages rows 0-3 of one (8, 128) chunk in shared memory, every ray tests the
// 128 spheres, and a block-wide max of min(best_t, tcap) decides whether the
// next chunk's least depth zmin can still matter.  The winner is kept as the
// flat slot c * 128 + j, so among equal t the earlier chunk wins, then the
// lower lane; a padded slot (r = -1) gets an infinite c term and never hits;
// a ray with tcap = -1e18 never keeps the walk alive.  The winner's 8-float
// record is read once, at the end (zeros on a miss, where best_t is 1e18).
// What bounds it on the card: the rays cost 28 bytes in and 36 bytes out each
// and a chunk is read once per block, against about 16 fp32 operations per
// sphere test; where the early exit leaves few chunks, the ray traffic is the
// larger of the two.
//
// Shadow filter.  One thread per ray: a ray with lit = 0 returns 1; a lit ray
// walks the records of its light-grid cell in descending far-key order and
// stops at the first occluder, or once key <= tau + eps (the walk of
// render_common.cuh, shared with mega_render.cu's primary-light sweep), over
// the port's compact CSR (M, 8) rows.  Walk lengths vary from ray to ray, so
// warps diverge; the rays of a warp are neighbours on the screen and mostly
// share a cell, which keeps the record reads in cache.
//
// Built by mdapy_tpu_torch/render/_build.py with nvcc for sm_90a into a
// shared library with a plain C interface (ctypes), with -fmad=false so that
// a*b+c rounds twice, as the plain torch versions do.

#include "render_common.cuh"

namespace {

using render::BIG;
using render::CH;

constexpr int NT = 256;          // threads per closest-hit block
constexpr int RPT = 8;           // rays a thread holds
constexpr int SLICE = NT * RPT;  // most rays per block

__global__ void __launch_bounds__(NT)
closest_hit_kernel(const float* __restrict__ o,       // (nb, R, 3)
                   const float* __restrict__ d,       // (nb, R, 3)
                   const float* __restrict__ tcap,    // (nb, R)
                   const float* __restrict__ zmin,    // (nb, nchunks)
                   const float* __restrict__ chunks,  // (nb, nchunks, 8, CH)
                   float* __restrict__ best_t,        // (nb, R)
                   float* __restrict__ rec,           // (nb, R, 8)
                   int R, int nchunks, float eps) {
  __shared__ float4 cand[CH];
  __shared__ float red[NT / 32];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lo = (int)((long long)blockIdx.y * R / gridDim.y);
  const int hi = (int)((long long)(blockIdx.y + 1) * R / gridDim.y);
  const size_t ray0 = (size_t)tile * R;
  const float* tzmin = zmin + (size_t)tile * nchunks;
  const float* tchunks = chunks + (size_t)tile * nchunks * 8 * CH;

  float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT];
  float cap[RPT], bt[RPT];
  int bidx[RPT];
  float need = -BIG;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = lo + k * NT + tid;
    bt[k] = BIG;
    bidx[k] = -1;
    cap[k] = -BIG;
    ox[k] = oy[k] = oz[k] = dx[k] = dy[k] = dz[k] = 0.0f;
    if (r < hi) {
      const float* op = o + 3 * (ray0 + r);
      const float* dp = d + 3 * (ray0 + r);
      ox[k] = op[0];
      oy[k] = op[1];
      oz[k] = op[2];
      dx[k] = dp[0];
      dy[k] = dp[1];
      dz[k] = dp[2];
      cap[k] = tcap[ray0 + r];
      need = fmaxf(need, cap[k]);
    }
  }
  need = render::block_max<NT>(need, red);

  for (int c = 0; c < nchunks; ++c) {
    if (!(tzmin[c] < need)) break;  // uniform across the block
    if (tid < CH) {
      const float* ch = tchunks + (size_t)c * 8 * CH;
      const float r = ch[3 * CH + tid];
      // a dead slot gets r^2 = -inf, so its c term is +inf and it never hits
      cand[tid] = make_float4(ch[tid], ch[CH + tid], ch[2 * CH + tid],
                              r > 0.0f ? r * r : -INFINITY);
    }
    __syncthreads();
    for (int j = 0; j < CH; ++j) {
      const float4 q = cand[j];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        if (lo + k * NT + tid < hi) {
          const float ocx = ox[k] - q.x, ocy = oy[k] - q.y, ocz = oz[k] - q.z;
          const float b = ocx * dx[k] + ocy * dy[k] + ocz * dz[k];
          const float ccb = ocx * ocx + ocy * ocy + ocz * ocz - q.w;
          const float disc = b * b - ccb;
          if (disc >= 0.0f) {
            const float t = render::sphere_root(b, disc, eps);
            if (t < bt[k]) {
              bt[k] = t;
              bidx[k] = c * CH + j;
            }
          }
        }
      }
    }
    float ln = -BIG;
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (lo + k * NT + tid < hi) ln = fmaxf(ln, fminf(bt[k], cap[k]));
    need = render::block_max<NT>(ln, red);  // its barriers retire this chunk's reads
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = lo + k * NT + tid;
    if (r < hi) {
      best_t[ray0 + r] = bt[k];
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (bidx[k] >= 0) {
        const float* rp = tchunks + (size_t)(bidx[k] / CH) * 8 * CH + (bidx[k] % CH);
        a = make_float4(rp[0], rp[CH], rp[2 * CH], rp[3 * CH]);
        b = make_float4(rp[4 * CH], rp[5 * CH], rp[6 * CH], rp[7 * CH]);
      }
      float4* out = reinterpret_cast<float4*>(rec + 8 * (ray0 + r));
      out[0] = a;
      out[1] = b;
    }
  }
}

__global__ void __launch_bounds__(256)
shadow_filter_kernel(const float* __restrict__ uvt,    // (n, 3) u, v, tau
                     const int* __restrict__ cellxy,   // (n, 2) gx, gy
                     const int* __restrict__ lit,      // (n,)
                     const float4* __restrict__ lrec,  // (M, 2) float4 rows
                     const int* __restrict__ offs,     // (ncells,)
                     const int* __restrict__ cnt,      // (ncells,)
                     float* __restrict__ filt,         // (n,)
                     long long n, int grid_n, float eps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float f = 1.0f;
  if (lit[i] > 0) {
    const int gx = min(max(cellxy[2 * i], 0), grid_n - 1);
    const int gy = min(max(cellxy[2 * i + 1], 0), grid_n - 1);
    const int cell = gy * grid_n + gx;
    const int c = cnt[cell];
    if (c > 0 && render::walk_cell(lrec + 2 * (size_t)offs[cell], c, uvt[3 * i],
                                   uvt[3 * i + 1], uvt[3 * i + 2] + eps))
      f = 0.0f;
  }
  filt[i] = f;
}

}  // namespace

// Launches the closest hit on `stream` over nb tiles of R rays each and
// returns cudaGetLastError().  rec must be 16-byte aligned.  A tile's rays are
// cut into ceil(R / 2048) equal slices, one block each.
extern "C" int closest_hit_spheres_launch(const float* o, const float* d,
                                          const float* tcap, const float* zmin,
                                          const float* chunks, float* best_t,
                                          float* rec, int nb, int R,
                                          int nchunks, float eps, void* stream) {
  if (nb < 1 || R < 1 || nchunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nslices = (R + SLICE - 1) / SLICE;
  if (nslices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  closest_hit_kernel<<<dim3(nb, nslices), NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      o, d, tcap, zmin, chunks, best_t, rec, R, nchunks, eps);
  return static_cast<int>(cudaGetLastError());
}

// Launches the shadow filter on `stream` over n rays and returns
// cudaGetLastError().  lrec must be 16-byte aligned (M, 8) rows
// [cu, cv, ck, r, key, alpha, 0, 0], each cell's by descending key.
extern "C" int shadow_filter_launch(const float* uvt, const int* cellxy,
                                    const int* lit, const float* lrec,
                                    const int* offs, const int* cnt,
                                    float* filt, long long n, int grid_n,
                                    float eps, void* stream) {
  if (n < 1 || grid_n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + 255) / 256;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  shadow_filter_kernel<<<(unsigned)blocks, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      uvt, cellxy, lit, reinterpret_cast<const float4*>(lrec), offs, cnt, filt,
      n, grid_n, eps);
  return static_cast<int>(cudaGetLastError());
}
