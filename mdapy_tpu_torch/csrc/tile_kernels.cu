// Hand CUDA kernels of the tiled tracer for Hopper (sm_90a): the chunked
// sphere closest hit and the light-grid shadow filter.
//
// closest_hit_kernel replaces the Pallas TPU kernel
// mdapy_tpu/render/pallas_kernels.py:_kernel (launched at :459 by
// closest_hit_spheres_tiles); shadow_filter_kernel with shadow_walk_kernel
// replaces pallas_kernels.py:_shadow_kernel (launched at :403 by
// shadow_filter_tiles).  They compute what those kernels compute; neither
// is a block-by-block translation.
//
// Closest hit.  One block per tile and slice of at most SLICE = 2,048 rays
// (a tile with more rays is cut into equal slices, as the TPU wrapper cuts
// its ray blocks); the slice's rays share the early exit.  The block walks
// the tile's depth-sorted 128-wide candidate chunks front to back while
// zmin[c] < the block max of min(best_t, tcap), so among equal t the earlier
// chunk wins, then the lower lane; a padded slot (r <= 0) never hits.  The
// winner's 8-float record is read once at the end (zeros on a miss, where
// best_t is 1e18).
// What bounds it on the card: it moves 64 bytes a ray and reads each chunk
// it reaches once, against about 16 fp32 operations a sphere test; at
// -fmad=false a test issues an instruction a term, so the tests are bound
// by instruction issue, and a block's ray loads and result stores leave its
// SM idle unless other blocks' tests fill it.
// What the design does about it:
// - A slice whose rays all start at one point (the perspective camera),
//   found by one __syncthreads_and, tests the staged ray-independent terms
//   oc = origin - centre and |oc|^2 - r^2: b = oc.d and b^2 >= |oc|^2 - r^2
//   are seven instructions; they are the per-ray test's terms in its order,
//   and b^2 - c >= 0 exactly when b^2 >= c, so the results are bit for bit
//   the same.  A first pass over 32 candidates only marks hits, without a
//   branch; the few marked ones then take the square root in ascending
//   order.  Other slices read their origins again at each chunk, so no
//   register holds them across the walk.
// - A thread holds RPT = 4 rays and the block has ceil(slice / 128) warps:
//   the main path's slice of 1,664 rays (16x16 pixels x 13 samples, two
//   slices a tile) is 13 full warps, and at most 40 registers (three
//   blocks an SM) keep three blocks' loads, tests and stores overlapping.
// - A slice whose rays all end before chunk 0 (60 % of the main path's)
//   writes its misses without reading its rays.
// - Rows 0-3 of chunk c + 1 arrive by cp.async while chunk c is tested
//   (chunk 0's while the rays load), in two candidate buffers, with one
//   barrier a chunk: the block max, which writes into one of two slots
//   flipped on every call.
//
// Shadow filter.  A ray with lit = 0 gets 1; a lit ray is blocked (0) by
// the first record of its light-grid cell that occludes it, in descending
// far-key order, unless a record with key <= tau + eps comes first.  The
// records are the port's compact CSR (M, 8) rows.  The filter is binary,
// so the order in which rays are walked moves no result.
// What bounds it: the lit rays' record walks, of a few to 2,500 records
// (one lit ray in a hundred under the main path's light, a third lit from
// beside the camera); one thread a ray left a warp with one lit lane
// waiting on its walk, or a warp with many waiting on the longest.
// What the design does about it:
// - shadow_filter_kernel, one thread a ray: an unlit ray, an empty cell or
//   a cell whose first key is at most tau + eps writes 1 and leaves.  A
//   block with fewer than DENSE = 32 walks queues them in the caller's
//   scratch buffer, one atomic a block, in ray order; a denser block walks
//   them in place, one thread a ray, where a warp's rays mostly share a
//   cell and each record is one broadcast read (a warp walk reads a record
//   once a ray, and for the dense bands that costs more, PERF.md).
// - shadow_walk_kernel, persistent blocks over the queue in rounds of 256
//   entries: a thread walks an entry's first WALK_SERIAL = 32 records (two
//   loaded at a time), then the walks left go to the block's warps, one
//   warp a walk, 32 records a step with the next step loaded ahead;
//   __ballot_sync finds the first stop and the first occluder of a step.
//
// Built by mdapy_tpu_torch/render/_build.py with nvcc for sm_90a into a
// shared library with a plain C interface (ctypes), with -fmad=false so that
// a*b+c rounds twice, as the plain torch versions do.

#include <limits.h>

#include "render_common.cuh"

namespace {

using render::BIG;
using render::CH;
using render::sphere_root;

constexpr unsigned FULL = 0xffffffffu;

// ---- closest hit ------------------------------------------------------------

constexpr int SLICE = 2048;            // most rays of a tile that share one exit
constexpr int RPT = 4;                 // rays a thread holds
constexpr int MAX_NT = SLICE / RPT;    // threads of the largest block
constexpr int MAX_NW = MAX_NT / 32;

// Block-wide max with one barrier: each warp's max goes to slot rsel of red
// (two slots), which flips on every call; a call's slot was last read before
// the previous call's barrier.  Every thread of the block must call it.
__device__ __forceinline__ float block_max(float v, float (*red)[MAX_NW],
                                           int& rsel) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  float* r = red[rsel];
  rsel ^= 1;
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = r[0];
  const int nw = blockDim.x >> 5;
  for (int w = 1; w < nw; ++w) m = fmaxf(m, r[w]);
  return m;
}

// The chunk pipeline.  Rows 0-3 of a chunk are 256 pairs of floats: pair vt
// is candidate j = 16 * (vt / 32) + vt % 16, rows 0-1 for vt % 32 < 16 and
// rows 2-3 above, so the two halves of a candidate lie in one warp, on
// lanes l and l ^ 16.  Thread t copies the pairs t, t + NT, ... by cp.async
// and later stages the same pairs, so it reads only its own copies.

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void chunk_fetch(const float* __restrict__ ch,
                                            float* craw) {
  for (int vt = threadIdx.x; vt < 2 * CH; vt += blockDim.x) {
    const int j = (vt >> 5) * 16 + (vt & 15);
    const int row = (vt & 16) ? 2 : 0;
    cp_async4(craw + row * CH + j, ch + row * CH + j);
    cp_async4(craw + (row + 1) * CH + j, ch + (row + 1) * CH + j);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for this thread's copies, trades halves with lane ^ 16 and writes
// candidate j's terms to cand: with one origin (ox, oy, oz) for every ray,
// oc = origin - centre and |oc|^2 - r^2 (+inf for a padded slot, so its
// discriminant is negative); else the centre and r^2 (-inf when padded, so
// |oc|^2 - r^2 is +inf).  NT is a multiple of 32, so both lanes of a pair
// run the same iterations.
__device__ __forceinline__ void chunk_stage(const float* craw, float4* cand,
                                            bool camo, float ox, float oy,
                                            float oz) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int vt = threadIdx.x; vt < 2 * CH; vt += blockDim.x) {
    const int j = (vt >> 5) * 16 + (vt & 15);
    const int row = (vt & 16) ? 2 : 0;
    const float p0 = craw[row * CH + j], p1 = craw[(row + 1) * CH + j];
    const float q0 = __shfl_xor_sync(FULL, p0, 16);
    const float q1 = __shfl_xor_sync(FULL, p1, 16);
    if (row == 0) {
      const float cx = p0, cy = p1, cz = q0, r = q1;
      if (camo) {
        const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
        const float ccb = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
        cand[j] = make_float4(ocx, ocy, ocz, r > 0.0f ? ccb : INFINITY);
      } else {
        cand[j] = make_float4(cx, cy, cz, r > 0.0f ? r * r : -INFINITY);
      }
    }
  }
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// Slot k of a thread is ray lo + k * NT + tid.  A slot past the slice (only
// where the slice is not a multiple of 32 * RPT) tests like the others from
// a zero ray with tcap = -1e18: it never raises the block's bound and is
// never stored.  The origins are held in registers only while a slice
// whose rays start apart is tested (they are read again at each chunk).
__global__ void __launch_bounds__(MAX_NT, 3)
closest_hit_kernel(const float* __restrict__ o,       // (nb, R, 3)
                   const float* __restrict__ d,       // (nb, R, 3)
                   const float* __restrict__ tcap,    // (nb, R)
                   const float* __restrict__ zmin,    // (nb, nchunks)
                   const float* __restrict__ chunks,  // (nb, nchunks, 8, CH)
                   float* __restrict__ best_t,        // (nb, R)
                   float* __restrict__ rec,           // (nb, R, 8)
                   int R, int nchunks, float eps) {
  __shared__ float craw[4 * CH];
  __shared__ float4 cand[2][CH];
  __shared__ float red[2][MAX_NW];

  const int NT = blockDim.x;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lo = (int)((long long)blockIdx.y * R / gridDim.y);
  const int hi = (int)((long long)(blockIdx.y + 1) * R / gridDim.y);
  const size_t ray0 = (size_t)tile * R;
  const float* tzmin = zmin + (size_t)tile * nchunks;
  const float* tchunks = chunks + (size_t)tile * nchunks * 8 * CH;

  int rsel = 0;  // block_max's slot
  {
    // a slice whose rays all end before chunk 0 walks nothing: it writes
    // its misses without reading its rays
    float cmax = -BIG;
    for (int r = lo + tid; r < hi; r += NT) cmax = fmaxf(cmax, tcap[ray0 + r]);
    if (!(tzmin[0] < block_max(cmax, red, rsel))) {  // uniform
      for (int r = lo + tid; r < hi; r += NT) {
        best_t[ray0 + r] = BIG;
        float4* out = reinterpret_cast<float4*>(rec + 8 * (ray0 + r));
        out[0] = out[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
  }
  chunk_fetch(tchunks, craw);  // chunk 0 in flight while the rays load

  const float* o0 = o + 3 * (ray0 + lo);
  const float cx0 = o0[0], cy0 = o0[1], cz0 = o0[2];
  float dx[RPT], dy[RPT], dz[RPT], cap[RPT], bt[RPT];
  int bidx[RPT];
  float need = -BIG;
  bool same = true;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = lo + k * NT + tid;
    bt[k] = BIG;
    bidx[k] = -1;
    cap[k] = -BIG;
    dx[k] = dy[k] = dz[k] = 0.0f;
    if (r < hi) {
      const float* op = o + 3 * (ray0 + r);
      const float* dp = d + 3 * (ray0 + r);
      same = same && same_bits(op[0], cx0) && same_bits(op[1], cy0) &&
             same_bits(op[2], cz0);
      dx[k] = dp[0];
      dy[k] = dp[1];
      dz[k] = dp[2];
      cap[k] = tcap[ray0 + r];
      need = fmaxf(need, cap[k]);
    }
  }
  const bool camo = __syncthreads_and(same);  // uniform
  chunk_stage(craw, cand[0], camo, cx0, cy0, cz0);
  need = block_max(need, red, rsel);  // its barrier publishes chunk 0

  int cbuf = 0;  // the buffer that holds chunk c
  for (int c = 0; c < nchunks; ++c) {
    if (!(tzmin[c] < need)) break;  // uniform across the block
    // need only falls, so a chunk it does not reach now is never tested
    const bool ahead = c + 1 < nchunks && tzmin[c + 1] < need;
    if (ahead) chunk_fetch(tchunks + (size_t)(c + 1) * 8 * CH, craw);
    const float4* cc = cand[cbuf];
    if (camo) {
      // q = (oc, |oc|^2 - r^2): disc = b^2 - q.w >= 0 exactly when b^2 >=
      // q.w.  32 candidates at a time: a branch-free pass marks each ray's
      // hits, then its marked candidates are taken in ascending j, so the
      // earlier candidate still wins a tie.
      for (int j0 = 0; j0 < CH; j0 += 32) {
        unsigned hits[RPT];
#pragma unroll
        for (int k = 0; k < RPT; ++k) hits[k] = 0u;
#pragma unroll
        for (int jj = 0; jj < 32; ++jj) {
          const float4 q = cc[j0 + jj];
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            const float b = q.x * dx[k] + q.y * dy[k] + q.z * dz[k];
            if (b * b >= q.w) hits[k] |= 1u << jj;
          }
        }
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          for (unsigned m = hits[k]; m; m &= m - 1u) {
            const int j = j0 + __ffs(m) - 1;
            const float4 q = cc[j];
            const float b = q.x * dx[k] + q.y * dy[k] + q.z * dz[k];
            const float t = sphere_root(b, b * b - q.w, eps);
            if (t < bt[k]) {
              bt[k] = t;
              bidx[k] = c * CH + j;
            }
          }
        }
      }
    } else {
      float ox[RPT], oy[RPT], oz[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = lo + k * NT + tid;
        ox[k] = oy[k] = oz[k] = 0.0f;
        if (r < hi) {
          const float* op = o + 3 * (ray0 + r);
          ox[k] = op[0];
          oy[k] = op[1];
          oz[k] = op[2];
        }
      }
      for (int j = 0; j < CH; ++j) {
        const float4 q = cc[j];
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const float ocx = ox[k] - q.x, ocy = oy[k] - q.y, ocz = oz[k] - q.z;
          const float b = ocx * dx[k] + ocy * dy[k] + ocz * dz[k];
          const float ccb = ocx * ocx + ocy * ocy + ocz * ocz - q.w;
          if (b * b >= ccb) {
            const float t = sphere_root(b, b * b - ccb, eps);
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
    for (int k = 0; k < RPT; ++k) ln = fmaxf(ln, fminf(bt[k], cap[k]));
    if (ahead) chunk_stage(craw, cand[cbuf ^ 1], camo, cx0, cy0, cz0);
    // one barrier: the block max, chunk c + 1 published, chunk c retired
    need = block_max(ln, red, rsel);
    cbuf ^= 1;
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

// ---- shadow filter ----------------------------------------------------------

constexpr int FT = 256;           // rays of a shadow-filter block, one a thread
constexpr int FW = FT / 32;
constexpr int DENSE = 32;         // walks from which a block walks in place
constexpr int WALK_SERIAL = 32;   // records a thread walks before a warp takes over
constexpr int WALK_BLOCKS_SM = 8; // walk blocks launched for each SM; each loops over the queue

// Record a = [cu, cv, ck, r] occludes the point (u, v) at tau + eps = te
// (mega_render.cu's test, repeated here so that its source stays its own).
__device__ __forceinline__ bool rec_occludes(float4 a, float u, float v,
                                             float te) {
  const float du = a.x - u, dv = a.y - v;
  const float s2 = a.w * a.w - (du * du + dv * dv);
  const float q = te - a.z;
  return s2 > 0.0f && a.w > 0.0f && (q < 0.0f || s2 > q * q);
}

__device__ __forceinline__ int cell_of(const int* __restrict__ cellxy,
                                       long long i, int grid_n) {
  const int gx = min(max(cellxy[2 * i], 0), grid_n - 1);
  const int gy = min(max(cellxy[2 * i + 1], 0), grid_n - 1);
  return gy * grid_n + gx;
}

// One block of FT rays, one a thread.  An unlit ray, an empty cell or a
// cell whose first key is at most tau + eps gives 1.  The other rays need
// a walk.  A block with fewer than DENSE of them puts them on the queue
// (queue[0 .. *qcount), in ray order, one atomic a block) for
// shadow_walk_kernel; a block with more walks them in place, one thread a
// ray, two records loaded at a time: the rays of a warp are neighbours on
// the screen and mostly walk one cell, so a step's record is one broadcast
// read for the warp.
__global__ void __launch_bounds__(FT)
shadow_filter_kernel(const float* __restrict__ uvt,    // (n, 3) u, v, tau
                     const int* __restrict__ cellxy,   // (n, 2) gx, gy
                     const int* __restrict__ lit,      // (n,)
                     const float4* __restrict__ lrec,  // (M, 2) float4 rows
                     const int* __restrict__ offs,     // (ncells,)
                     const int* __restrict__ cnt,      // (ncells,)
                     float* __restrict__ filt,         // (n,)
                     int* __restrict__ queue, int* __restrict__ qcount,
                     long long n, int grid_n, float eps) {
  __shared__ int wc[FW];
  __shared__ int qbase;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long i = (long long)blockIdx.x * FT + tid;
  bool walk = false;
  int cell = 0;
  float te = 0.0f;
  if (i < n) {
    if (lit[i] > 0) {
      cell = cell_of(cellxy, i, grid_n);
      te = uvt[3 * i + 2] + eps;
      walk = cnt[cell] > 0 && lrec[2 * (size_t)offs[cell] + 1].x > te;
    }
    if (!walk) filt[i] = 1.0f;
  }
  // the block's walks, counted by warp
  const unsigned m = __ballot_sync(FULL, walk);
  if (lane == 0) wc[w] = __popc(m);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int k = 0; k < FW; ++k) {
    before += k < w ? wc[k] : 0;
    total += wc[k];
  }
  if (total < DENSE) {  // uniform: a sparse block queues its walks
    if (tid == 0 && total > 0) qbase = atomicAdd(qcount, total);
    __syncthreads();
    if (walk) queue[qbase + before + __popc(m & ((1u << lane) - 1u))] = (int)i;
    return;
  }
  if (!walk) return;
  const float4* rp = lrec + 2 * (size_t)offs[cell];
  const int nrec = cnt[cell];
  const float u = uvt[3 * i], v = uvt[3 * i + 1];
  float f = 1.0f;
  for (int k = 0; k < nrec; k += 2) {
    const float4 a0 = rp[2 * k];
    const float k0 = rp[2 * k + 1].x;
    float4 a1 = a0;
    float k1 = k0;
    if (k + 1 < nrec) {
      a1 = rp[2 * k + 2];
      k1 = rp[2 * k + 3].x;
    }
    if (k0 <= te) break;
    if (rec_occludes(a0, u, v, te)) {
      f = 0.0f;
      break;
    }
    if (k + 1 >= nrec || k1 <= te) break;
    if (rec_occludes(a1, u, v, te)) {
      f = 0.0f;
      break;
    }
  }
  filt[i] = f;
}

// Entry e of a round walked by one thread for at most WALK_SERIAL records,
// two loaded at a time.  Returns true when the walk ended (blocked says
// how); else the entry keeps its progress for a warp.
__device__ __forceinline__ bool walk_serial(const float4* __restrict__ rp,
                                            int n, float u, float v, float te,
                                            int& walked, bool& blocked) {
  const int m = min(n, WALK_SERIAL);
  int i = 0;
  while (i < m) {
    float4 a[2];
    float key[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (i + r < m) {
        a[r] = rp[2 * (i + r)];
        key[r] = rp[2 * (i + r) + 1].x;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (i < m) {  // record i is record r of the two
        if (key[r] <= te) return true;
        if (rec_occludes(a[r], u, v, te)) {
          blocked = true;
          return true;
        }
        ++i;
      }
    }
  }
  walked = i;
  return i >= n;
}

// The rest of a walk by the calling warp: 32 records a step, the next
// step's records loaded before this step is tested; lanes past the end
// count as a stop.  Every lane returns the same answer.
__device__ __forceinline__ bool walk_warp(const float4* __restrict__ rp,
                                          int n, float u, float v, float te) {
  const int lane = threadIdx.x & 31;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float key = 0.0f;
  if (lane < n) {
    a = rp[2 * lane];
    key = rp[2 * lane + 1].x;
  }
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    float4 na = a;
    float nkey = key;
    if (i + 32 < n) {
      na = rp[2 * (i + 32)];
      nkey = rp[2 * (i + 32) + 1].x;
    }
    const bool live = i < n;
    const uint32_t sb = __ballot_sync(FULL, !live || key <= te);
    uint32_t ob = __ballot_sync(FULL, live && rec_occludes(a, u, v, te));
    if (sb) ob &= (1u << (__ffs(sb) - 1)) - 1u;  // occluders before the stop
    if (ob) return true;
    if (sb) return false;
    a = na;
    key = nkey;
  }
  return false;
}

// Persistent blocks over the queue, FT entries a round: one thread an entry
// for its first WALK_SERIAL records, then one warp for each walk left.
__global__ void __launch_bounds__(FT)
shadow_walk_kernel(const float* __restrict__ uvt,
                   const int* __restrict__ cellxy,
                   const float4* __restrict__ lrec,
                   const int* __restrict__ offs,
                   const int* __restrict__ cnt,
                   float* __restrict__ filt,
                   const int* __restrict__ queue,
                   const int* __restrict__ qcount, int grid_n, float eps) {
  __shared__ int q_ray[FT], q_off[FT], q_cnt[FT];
  __shared__ float q_u[FT], q_v[FT], q_te[FT];
  __shared__ short lng[FT];
  __shared__ int nlong, next;

  const int total = *qcount;
  const int tid = threadIdx.x;
  for (int base = blockIdx.x * FT; base < total; base += gridDim.x * FT) {
    if (tid == 0) {
      nlong = 0;
      next = 0;
    }
    __syncthreads();
    const int e = base + tid;
    if (e < total) {
      const int i = queue[e];
      const int cell = cell_of(cellxy, i, grid_n);
      const int off = offs[cell], n = cnt[cell];
      const float u = uvt[3 * (size_t)i], v = uvt[3 * (size_t)i + 1];
      const float te = uvt[3 * (size_t)i + 2] + eps;
      int walked = 0;
      bool blocked = false;
      if (walk_serial(lrec + 2 * (size_t)off, n, u, v, te, walked, blocked)) {
        filt[i] = blocked ? 0.0f : 1.0f;
      } else {
        q_ray[tid] = i;
        q_off[tid] = off + walked;
        q_cnt[tid] = n - walked;
        q_u[tid] = u;
        q_v[tid] = v;
        q_te[tid] = te;
        lng[atomicAdd(&nlong, 1)] = (short)tid;
      }
    }
    __syncthreads();
    const int nl = nlong;
    while (nl > 0) {  // uniform across each warp
      int k = 0;
      if ((tid & 31) == 0) k = atomicAdd(&next, 1);
      k = __shfl_sync(FULL, k, 0);
      if (k >= nl) break;
      const int s = lng[k];
      const bool blocked = walk_warp(lrec + 2 * (size_t)q_off[s], q_cnt[s],
                                     q_u[s], q_v[s], q_te[s]);
      if ((tid & 31) == 0) filt[q_ray[s]] = blocked ? 0.0f : 1.0f;
    }
    __syncthreads();  // the round's entries are read before the next resets
  }
}

}  // namespace

// Launches the closest hit on `stream` over nb tiles of R rays each and
// returns cudaGetLastError().  rec must be 16-byte aligned.  A tile's rays are
// cut into ceil(R / 2048) equal slices, one block each, of ceil(slice / 128)
// warps.
extern "C" int closest_hit_spheres_launch(const float* o, const float* d,
                                          const float* tcap, const float* zmin,
                                          const float* chunks, float* best_t,
                                          float* rec, int nb, int R,
                                          int nchunks, float eps, void* stream) {
  if (nb < 1 || R < 1 || nchunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nslices = (R + SLICE - 1) / SLICE;
  if (nslices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int longest = (R + nslices - 1) / nslices;
  const int nt = (longest + 32 * RPT - 1) / (32 * RPT) * 32;
  closest_hit_kernel<<<dim3(nb, nslices), nt, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      o, d, tcap, zmin, chunks, best_t, rec, R, nchunks, eps);
  return static_cast<int>(cudaGetLastError());
}

// Launches the shadow filter on `stream` over n rays and returns the first
// CUDA error.  lrec must be 16-byte aligned (M, 8) rows [cu, cv, ck, r, key,
// alpha, 0, 0], each cell's by descending key; scratch holds n + 1 ints (the
// queue's count, then the queue).
extern "C" int shadow_filter_launch(const float* uvt, const int* cellxy,
                                    const int* lit, const float* lrec,
                                    const int* offs, const int* cnt,
                                    float* filt, int* scratch, long long n,
                                    int grid_n, float eps, void* stream) {
  if (n < 1 || n > INT_MAX || grid_n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(scratch, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + FT - 1) / FT;
  const auto* rows = reinterpret_cast<const float4*>(lrec);
  shadow_filter_kernel<<<(unsigned)blocks, FT, 0, s>>>(
      uvt, cellxy, lit, rows, offs, cnt, filt, scratch + 1, scratch, n, grid_n,
      eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long walkers = blocks < (long long)sms * WALK_BLOCKS_SM
                                ? blocks : (long long)sms * WALK_BLOCKS_SM;
  shadow_walk_kernel<<<(unsigned)walkers, FT, 0, s>>>(
      uvt, cellxy, rows, offs, cnt, filt, scratch + 1, scratch, grid_n, eps);
  return static_cast<int>(cudaGetLastError());
}

// out[0..4) = registers, local bytes, static shared bytes and blocks an SM
// of kernel `which` (0: the closest hit, for the blocks of a tile of R rays;
// 1: the shadow filter; 2: the queued walks); returns a CUDA error code.
extern "C" int tile_kernels_attrs(int which, int R, int* out) {
  const void* kernel = which == 0 ? (const void*)closest_hit_kernel
                     : which == 1 ? (const void*)shadow_filter_kernel
                                  : (const void*)shadow_walk_kernel;
  int threads = FT;
  if (which == 0) {
    const int nslices = (R + SLICE - 1) / SLICE;
    const int longest = (R + nslices - 1) / nslices;
    threads = (longest + 32 * RPT - 1) / (32 * RPT) * 32;
  }
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return static_cast<int>(e);
}
