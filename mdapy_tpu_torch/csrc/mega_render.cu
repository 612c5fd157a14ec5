// Hand CUDA kernel for the render pass of one frame: raygen with AA jitter,
// front-to-back sphere closest hit, the bond / box-edge cylinders and their
// ring caps, Lambert shading, the primary light's shadow sweep, the
// ambient-occlusion sky lights, transparency peeling and the AA mean.
//
// Replaces the one-shot slice of the Pallas TPU kernel
// mdapy_tpu/render/megakernel.py:_mega_kernel (launched at :2051 by
// render_image_mega).  Not covered: the banded variant.  It computes what
// that kernel computes for the slice; it is not a block-by-block
// translation:
//   * one thread block per 16x16 screen tile, one thread per pixel, the AA
//     samples looped inside the thread in groups of up to SG (each group
//     shares one walk over the tile's candidate chunks);
//   * the chunk walk is a two-stage pipeline: while the block tests chunk c,
//     rows 0-3 (x, y, z, r) of chunk c + 1 arrive by cp.async, every thread
//     copying two of a candidate's four values, and once its copies land
//     each pair of lanes trades halves by a shuffle and writes the
//     candidate's ray-independent terms (r^2 and sqrt(r^2); for
//     perspective also o - c and the gate's (1 - 2^-18) |o - c|^2 - r^2)
//     into the second of two buffers.  A ray takes a candidate's stable
//     discriminant r^2 - |w|^2, w = oc - b d (b = oc.d), which keeps the
//     hit within float32's rounding of the surface with the camera hundreds
//     of Angstrom away, only where -b - sqrt(r^2) lies before its best t
//     (no root comes earlier) and, for a camera ray, b^2 passes that gate:
//     the walk's sqrt runs for the few spheres that can still win.  The
//     result is the smallest stable root, as the plain version takes it
//     over every candidate.  The zmin early exit is
//     the same per-chunk test (tzmin[c] < the block max of min(best_t,
//     tcap)); a chunk that test cannot reach is not fetched.  The block max
//     of a chunk and the buffer swap share one barrier: each warp writes its
//     max into one of two slots, so a chunk costs one __syncthreads;
//   * ties in t keep the lowest slot of the earliest chunk, as the TPU
//     kernel's exclusive one-hot select does;
//   * shadows: after a sample group's surfaces, every lit point whose
//     light-grid cell can occlude it (a count > 0 and a max key above tau +
//     eps, read before queueing) enters a shared-memory queue of walks: (the
//     cell's record offset and count, u, v, tau + eps), placed by a prefix
//     over the block so that each thread finds its entries again.  Sample 0
//     queues its AO sky lights in the same batch.  Each queued walk first
//     runs one thread per entry for up to WALK_SERIAL records (the opaque
//     frames' walks end there); the walks left go one warp per walk: the 32
//     lanes read records i..i+31 together (1 KB, coalesced), each tests the
//     key stop and the occlusion of its record, and two ballots give the
//     first stop and the occluders before it.  A binary walk is blocked by
//     any of them; a transmission walk multiplies the factors 1 - alpha (0
//     at alpha >= 0.99999) of the set bits one after another, in record
//     order, and stops at <= 1e-3, so the product rounds as the serial walk
//     rounds it (no tree scan).  A binary walk is the transmission walk with
//     every factor 0.  Every variant queues: in the cylinder variants the
//     queue's code makes the cyl/ring and occluder loops compile worse
//     (small scenes with short walks lose ~9 %), but walking in place there
//     costs a million-atom frame with its cell's edges 1.7x (PERF.md §6);
//   * with ambient occlusion (the AO template flag) lights 1..L-1 are the
//     directional sky lights of the JAX package's fast AO.  As in its
//     ao_shared mode, their occlusion is tested on AA sample 0's hit point
//     only, and kept as one bit per light.  Every sample then adds lit * n.L
//     * lightcol * (1 - bit) for each light in light order, with its own
//     normal.  The light rows (L x 16 floats) sit in shared memory;
//   * with cylinders and rings (the OTHER template flag) the block stages the
//     tile's cyl/ring records (at most 512, one per thread per batch) in
//     shared memory after the sphere walk, and each thread tests them for
//     each of its samples; a record replaces the best hit only when its t is
//     strictly smaller, so a sphere keeps a tie and the lowest slot wins
//     among cyl/rings.  A tile is live when it holds spheres or cyl/rings.
//     The normal is picked by the winner's type.  For each light, a lit ray
//     whose cell walk came back clear is also tested against the light's
//     occluder table (every live cylinder and ring, with light-space cull
//     data): the block reduces its lit rays' (u, v) rectangle and least tau,
//     compacts the entries that pass the conservative cull of the JAX kernel
//     (megakernel.py:1156-1194) into shared memory 256 at a time, and tests
//     them.  The primary light does this per sample group, each sky light on
//     sample 0, after the group's walks;
//   * with transparency (the PEEL template flag; megakernel.py:328-406,
//     1338-1396) the block runs up to n_peel peels, each over every sample
//     group, and a peel p > 0 only while the largest weight W over the
//     tile's samples exceeds 1e-4, the JAX kernel's tile-wide rule.  Each
//     ray's state between peels (origin, W, colour sums, camera depth: 8
//     floats) is kept per sample and pixel in dynamic shared memory, or in a
//     device buffer the caller passes where S makes that too large.  A peel
//     starts a ray at its previous hit plus eps along it (a miss at its own
//     origin); with n_peel > 1 the rays no longer share the camera as
//     origin, so the perspective chunk and cyl/ring tests take the per-ray
//     form, and the zmin exit adds each ray's camera depth.  The hit is
//     shaded as in the opaque kernel with transmissions for shadow bits:
//     the cell walks above, the occluder table multiplies every lit ray
//     whose transmission is > 0, its entries staged in table order so the
//     products round alike in every run, and each AO sky light keeps one
//     float per pixel, sample 0's transmission of this peel.  The colour
//     sums gain W * alpha * colour (a miss: the background at alpha 1), W
//     becomes W * (1 - alpha), and the frame is the sums plus W times the
//     background, averaged over the samples.  peel1 is n_peel = 1 with this
//     compositing.  Without PEEL the code is the opaque kernel.
//
// What bounds it on the card: per-ray sphere tests (about 10 fp32 operations
// each, ~128 per processed chunk) and the shadow walks, whose lengths vary
// from ray to ray (a translucent frame's transmission walks read hundreds of
// records a lit ray).  The queue keeps every warp busy on the walks whatever
// the share of lit lanes, and the warp walk turns a long walk into 32-record
// coalesced steps.  The tests are 3-wide f32 dot products that must round as
// the plain version's do, so the tensor cores do not serve them: a TF32
// wgmma would round the products differently and change hits.  Candidate
// records are read once per chunk per block, so device memory traffic is
// small next to the arithmetic.  With cylinders the dense per-tile cyl/ring
// tests (about 40 operations each) and the culled occluder tests add to it.
// The limits the front end keeps (at most 512 cyl/ring candidates in a tile
// and 8,192 live cylinders + rings with shadows or AO) are those of the JAX
// package; past them it takes another tracer.  Later work: persistent blocks
// over the live tiles, depth-sorted cyl/ring chunks.
//
// Built by mdapy_tpu_torch/render/_build.py with nvcc for sm_90a into a
// shared library with a plain C interface (ctypes).  It is compiled with
// -fmad=false so that a*b+c rounds twice, as the plain torch version does.

#include "render_common.cuh"

namespace {

using render::BIG;
using render::BIG_DEPTH;
using render::CH;
using render::sphere_root;

constexpr int TILE = 16;
constexpr int P = TILE * TILE;   // pixels per tile = threads per block
constexpr int NW = P / 32;       // warps per block
constexpr int SG = 8;            // most AA samples traced per chunk walk
constexpr int MAX_LIGHTS = 64;   // lights a launch takes (one mask bit each)
constexpr int OCB = P;           // cyl/ring records staged per batch
constexpr int OTHER_BIT = 1 << 30;  // winner index flag: a cyl/ring record
constexpr int WQ = 2 * P;        // shadow walks queued per round (OTHER)
// records a queued walk reads one thread per walk before a warp takes over
// the rest, 32 a step: chosen on the card from 0-128 (PERF.md §6)
constexpr int WALK_SERIAL = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MINCONTRIB = 1.0f / 512.0f;
constexpr float OPAQUE_ALPHA = 0.99999f;  // an occluder at or above blocks fully
constexpr float TRANS_FLOOR = 1e-3f;      // a walk ends at a transmission <= this
// a camera ray takes a candidate's stable test where b^2 >= GATE |oc|^2 - r^2:
// 2^-18 |oc|^2 below the walk's old b^2 >= |oc|^2 - r^2, far more than the
// rounding of either side, so every sphere the stable form hits passes
constexpr float GATE = 1.0f - 0x1p-18f;

// (tile, sample, pixel) -> jitter in [-0.5, 0.5): the JAX package's int32
// avalanche hash (megakernel.py:_hash_jitter), in wrapping uint32 arithmetic.
__device__ __forceinline__ void hash_jitter(uint32_t tile, uint32_t s,
                                            uint32_t seed, uint32_t pix,
                                            float& jx, float& jy) {
  uint32_t h0 = tile * 0x9E3779B9u + s * 0xC2B2AE35u + seed * 374761393u;
  uint32_t v = pix * 0x85EBCA6Bu + h0;
  v ^= v >> 16;
  v *= 2127912214u;
  v ^= v >> 15;
  v *= 0xC2B2AE35u;
  v ^= v >> 16;
  jx = (float)(v & 0xFFFFu) * (1.0f / 65536.0f) - 0.5f;
  jy = (float)((v >> 16) & 0xFFFFu) * (1.0f / 65536.0f) - 0.5f;
}

__device__ __forceinline__ void axis_exit(float o, float d, float lo, float hi,
                                          float& tn, float& tf) {
  float invd = 1.0f / (fabsf(d) > 1e-30f ? d : 1e-30f);
  float t0 = (lo - o) * invd;
  float t1 = (hi - o) * invd;
  tn = fminf(t0, t1);
  tf = fmaxf(t0, t1);
}

// Block-wide max with one barrier: each warp's max goes to slot rsel of red
// (two slots of NW floats), which flips on every call.  A call's slot was
// last read before the previous call's barrier, so no second barrier is
// needed.  Every thread gets the result; every thread must call it.
__device__ __forceinline__ float block_max(float v, float (*red)[NW], int& rsel) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  float* r = red[rsel];
  rsel ^= 1;
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = r[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = fmaxf(m, r[w]);
  return m;
}

// ---- the chunk pipeline ---------------------------------------------------
// Candidate j = 16 * warp + (lane & 15) of a chunk: lanes 0-15 copy its x and
// y, lanes 16-31 its z and r, into craw (4 rows of CH), by cp.async.

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void chunk_fetch(const float* __restrict__ ch,
                                            float* craw) {
  const int j = (threadIdx.x >> 5) * 16 + (threadIdx.x & 15);
  const int row = (threadIdx.x & 16) ? 2 : 0;
  cp_async4(craw + row * CH + j, ch + row * CH + j);
  cp_async4(craw + (row + 1) * CH + j, ch + (row + 1) * CH + j);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for this thread's copies (cp.async.wait_all makes them visible to the
// copying thread, and only it reads them), trades halves with lane ^ 16 and
// writes candidate j's ray-independent terms to cand and (r^2, sqrt(r^2))
// to crr (camo: every ray starts at (ox, oy, oz)).
__device__ __forceinline__ void chunk_stage(const float* craw, float4* cand,
                                            float2* crr, bool camo, float ox,
                                            float oy, float oz) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int j = (threadIdx.x >> 5) * 16 + (threadIdx.x & 15);
  const int row = (threadIdx.x & 16) ? 2 : 0;
  const float p0 = craw[row * CH + j], p1 = craw[(row + 1) * CH + j];
  const float q0 = __shfl_xor_sync(FULL, p0, 16);
  const float q1 = __shfl_xor_sync(FULL, p1, 16);
  if (row == 0) {
    const float cx = p0, cy = p1, cz = q0, r = q1;
    const float r2 = r * r;
    // a dead slot gets r^2 = -inf, so its discriminant is negative, and
    // with camo a gate of +inf, which no ray passes
    crr[j] = make_float2(r > 0.0f ? r2 : -INFINITY, sqrtf(r2));
    if (camo) {
      const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
      const float oo = ocx * ocx + ocy * ocy + ocz * ocz;
      cand[j] = make_float4(ocx, ocy, ocz, r > 0.0f ? oo * GATE - r2 : INFINITY);
    } else {
      cand[j] = make_float4(cx, cy, cz, 0.0f);
    }
  }
}

// ---- the shadow walks -----------------------------------------------------

// Light-space (u, v) and tau + eps of hit point h toward the light of row lp
// (dir, e1, e2, org, inv_cell), and its cell in the stacked CSR arrays, whose
// cells for this light start at cell0.
__device__ __forceinline__ int light_cell(const float* lp, float hx, float hy,
                                          float hz, int grid_n, int cell0,
                                          float eps, float& u, float& v,
                                          float& te) {
  u = hx * lp[3] + hy * lp[4] + hz * lp[5] - lp[9];
  v = hx * lp[6] + hy * lp[7] + hz * lp[8] - lp[10];
  const float tau = hx * lp[0] + hy * lp[1] + hz * lp[2];
  const float gmax = (float)(grid_n - 1);
  const float gx = fminf(fmaxf(floorf(u * lp[11]), 0.0f), gmax);
  const float gy = fminf(fmaxf(floorf(v * lp[11]), 0.0f), gmax);
  te = tau + eps;
  return cell0 + (int)gy * grid_n + (int)gx;
}

// True when the cell can occlude the point: it has records and its largest
// far key exceeds tau + eps.  Only such points queue a walk.
__device__ __forceinline__ bool cell_gate(const int* __restrict__ lcnt,
                                          const float* __restrict__ lkmax,
                                          int cell, float te) {
  return lcnt[cell] > 0 && lkmax[cell] > te;
}

// Record a = [cu, cv, ck, r] occludes the point (u, v) at tau + eps = te.
__device__ __forceinline__ bool rec_occludes(float4 a, float u, float v,
                                             float te) {
  const float du = a.x - u, dv = a.y - v;
  const float s2 = a.w * a.w - (du * du + dv * dv);
  const float q = te - a.z;
  return s2 > 0.0f && a.w > 0.0f && (q < 0.0f || s2 > q * q);
}

// The factor an occluder of alpha a leaves: 1 - a, or 0 at a >= 0.99999;
// always 0 in a binary walk.
template <bool TRANS>
__device__ __forceinline__ float occ_factor(float a) {
  return TRANS ? (a >= OPAQUE_ALPHA ? 0.0f : 1.0f - a) : 0.0f;
}

// The queue of one round of walks, in shared memory, an array per field.
struct WalkQueue {
  int* off;     // the walk's next record, into lrec's rows of two float4
  int* cnt;     // records left in the cell
  float* u;
  float* v;
  float* te;    // tau + eps
  float* tr;    // transmission so far: the result (0 = blocked when binary)
  short* lng;   // entries left for the warps
  int* nlong;   // their count
  int* next;    // the warps' next pick from lng
};

// Writes entry e: the walk of hit point h toward the light of row lp.
__device__ __forceinline__ void queue_walk(const WalkQueue& q, int e,
                                           const float* lp, float hx, float hy,
                                           float hz, int grid_n, int cell0,
                                           float eps,
                                           const int* __restrict__ loffs,
                                           const int* __restrict__ lcnt) {
  float u, v, te;
  const int cell = light_cell(lp, hx, hy, hz, grid_n, cell0, eps, u, v, te);
  q.off[e] = loffs[cell];
  q.cnt[e] = lcnt[cell];
  q.u[e] = u;
  q.v[e] = v;
  q.te[e] = te;
}

// Entry e walked by one thread for at most WALK_SERIAL records, from
// transmission 1, two records loaded at a time (four spill the opaque
// kernels' registers); an entry not finished then goes to the warps' list
// with its progress.
template <bool TRANS>
__device__ __forceinline__ void walk_serial(const float4* __restrict__ lrec,
                                            const WalkQueue& q, int e) {
  const int off = q.off[e], cnt = q.cnt[e];
  const float u = q.u[e], v = q.v[e], te = q.te[e];
  const float4* rp = lrec + 2 * (size_t)off;
  const int n = min(cnt, WALK_SERIAL);
  float tr = 1.0f;
  bool done = false;
  int i = 0;  // records walked
  while (i < n && !done) {
    float4 a[2], b[2];  // cu, cv, ck, r and key, alpha, 0, 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (i + r < n) {
        a[r] = rp[2 * (i + r)];
        b[r] = rp[2 * (i + r) + 1];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!done && i < n) {  // record i is record r of the two
        if (b[r].x <= te) {
          done = true;
        } else {
          if (rec_occludes(a[r], u, v, te)) {
            tr = tr * occ_factor<TRANS>(b[r].y);
            done = tr <= TRANS_FLOOR;
          }
          ++i;
        }
      }
    }
  }
  q.tr[e] = tr;
  if (!done && i < cnt) {
    q.off[e] = off + i;
    q.cnt[e] = cnt - i;
    q.lng[atomicAdd(q.nlong, 1)] = (short)e;
  }
}

// Entry e walked by the calling warp from its progress: 32 records a step,
// the next step's records loaded before this step is tested.  Every lane
// ends with the same transmission, lane 0 stores it.
template <bool TRANS>
__device__ __forceinline__ void walk_warp(const float4* __restrict__ lrec,
                                          const WalkQueue& q, int e) {
  const int lane = threadIdx.x & 31;
  const int cnt = q.cnt[e];
  const float u = q.u[e], v = q.v[e], te = q.te[e];
  const float4* rp = lrec + 2 * (size_t)q.off[e];
  float tr = q.tr[e];
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (lane < cnt) {
    a = rp[2 * lane];
    b = rp[2 * lane + 1];
  }
  for (int i0 = 0; i0 < cnt; i0 += 32) {
    const int i = i0 + lane;
    float4 na = a, nb = b;
    if (i + 32 < cnt) {
      na = rp[2 * (i + 32)];
      nb = rp[2 * (i + 32) + 1];
    }
    bool stop = true, occ = false;
    float f = 0.0f;
    if (i < cnt) {
      stop = b.x <= te;
      occ = rec_occludes(a, u, v, te);
      f = occ_factor<TRANS>(b.y);
    }
    const uint32_t sb = __ballot_sync(FULL, stop);
    uint32_t ob = __ballot_sync(FULL, occ);
    if (sb) ob &= (1u << (__ffs(sb) - 1)) - 1u;  // occluders before the stop
    bool done = sb != 0u;
    while (ob) {  // uniform: every lane holds the same ob and tr
      const int j = __ffs(ob) - 1;
      ob &= ob - 1u;
      tr = tr * __shfl_sync(FULL, f, j);
      if (tr <= TRANS_FLOOR) {
        done = true;
        break;
      }
    }
    if (done) break;
    a = na;
    b = nb;
  }
  if (lane == 0) q.tr[e] = tr;
}

// The n entries of a round: first one thread each for up to WALK_SERIAL
// records, then a warp for each walk left.  Every thread must call it; the
// results are published when it returns.
template <bool TRANS>
__device__ __forceinline__ void walk_round(const float4* __restrict__ lrec,
                                           const WalkQueue& q, int n) {
  for (int e = threadIdx.x; e < n; e += P) walk_serial<TRANS>(lrec, q, e);
  __syncthreads();
  const int nl = *q.nlong;
  if (nl == 0) return;  // uniform; the barrier above published the results
  for (;;) {
    int k = 0;
    if ((threadIdx.x & 31) == 0) k = atomicAdd(q.next, 1);
    k = __shfl_sync(FULL, k, 0);
    if (k >= nl) break;
    walk_warp<TRANS>(lrec, q, q.lng[k]);
  }
  __syncthreads();
}

// t of a camera ray against one cylinder body (typ 1) or ring disc (typ 2),
// BIG on a miss: the JAX kernel's dense pass (megakernel.py:513-549), with
// oc = ray origin - record position and the ray-independent op / cq terms
// (op = oc minus its axis part, cq = |op|^2 - rad^2) precomputed.  The body
// uses the stable perpendicular-vector form and s in [0, alen].
__device__ __forceinline__ float cylring_t(float ocx, float ocy, float ocz,
                                           float oca, float opx, float opy,
                                           float opz, float cq, float4 ax,
                                           float rad, float alen, float dx,
                                           float dy, float dz, float eps) {
  const float dda = ax.x * dx + ax.y * dy + ax.z * dz;
  if (ax.w == 1.0f) {
    const float dpx = dx - dda * ax.x, dpy = dy - dda * ax.y,
                dpz = dz - dda * ax.z;
    const float a2 = dpx * dpx + dpy * dpy + dpz * dpz;
    const float bq = opx * dpx + opy * dpy + opz * dpz;
    const float disc = bq * bq - a2 * cq;
    if (!(rad > 0.0f && disc >= 0.0f && a2 > 1e-12f)) return BIG;
    const float inv_a2 = 1.0f / a2;
    const float sq = sqrtf(disc);
    const float t1 = (-bq - sq) * inv_a2;
    const float t2 = (-bq + sq) * inv_a2;
    const float s1 = oca + t1 * dda;
    const float s2 = oca + t2 * dda;
    if (t1 > eps && s1 >= 0.0f && s1 <= alen) return t1;
    if (t2 > eps && s2 >= 0.0f && s2 <= alen) return t2;
    return BIG;
  }
  if (ax.w == 2.0f && rad > 0.0f && fabsf(dda) > 1e-12f) {
    const float tr0 = -oca / dda;
    const float rx = ocx + tr0 * dx, ry = ocy + tr0 * dy, rz = ocz + tr0 * dz;
    const float rho2 = rx * rx + ry * ry + rz * rz;
    if (tr0 > eps && rho2 <= rad * rad) return tr0;
  }
  return BIG;
}

// Block-wide min of v[0..N); every thread gets the results.
template <int N>
__device__ __forceinline__ void block_min(float (&v)[N], float* red) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int o = 16; o > 0; o >>= 1)
      v[i] = fminf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * (P / 32) + (threadIdx.x >> 5)] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float r = red[i * (P / 32)];
#pragma unroll
    for (int w = 1; w < P / 32; ++w) r = fminf(r, red[i * (P / 32) + w]);
    v[i] = r;
  }
}

// True when the cylinder body (b.w == 1) or ring disc (b.w == 2) staged as
// (a, b, e, f) blocks the point h toward the light direction l: a = (p,
// rad), b = (axis, typ), e = (l minus its axis part, its squared length
// a2), f = (axis.l, 1 / a2, alen, -), as occ_blocked stages them.  The test
// is occ_blocked's, which keeps its own copy inline: the opaque kernels'
// register allocation stays as it was before the peel kernels came.
__device__ __forceinline__ bool stage_occludes(float4 a, float4 b, float4 e,
                                               float4 f, float hx, float hy,
                                               float hz, float lx, float ly,
                                               float lz, float eps) {
  const float ocx = hx - a.x, ocy = hy - a.y, ocz = hz - a.z;
  const float oca = ocx * b.x + ocy * b.y + ocz * b.z;
  if (b.w == 1.0f) {
    const float opx = ocx - oca * b.x, opy = ocy - oca * b.y,
                opz = ocz - oca * b.z;
    const float bq = opx * e.x + opy * e.y + opz * e.z;
    const float cq = opx * opx + opy * opy + opz * opz - a.w * a.w;
    const float disc = bq * bq - e.w * cq;
    if (disc >= 0.0f && e.w > 1e-12f) {
      const float sq = sqrtf(disc);
      const float t1 = (-bq - sq) * f.y;
      const float t2 = (-bq + sq) * f.y;
      const float s1 = oca + t1 * f.x;
      const float s2 = oca + t2 * f.x;
      return (t1 > eps && s1 >= 0.0f && s1 <= f.z) ||
             (t2 > eps && s2 >= 0.0f && s2 <= f.z);
    }
  } else if (b.w == 2.0f && fabsf(f.x) > 1e-12f) {
    const float tr0 = -oca / f.x;
    const float rx = ocx + tr0 * lx, ry = ocy + tr0 * ly, rz = ocz + tr0 * lz;
    return tr0 > eps && rx * rx + ry * ry + rz * rz <= a.w * a.w;
  }
  return false;
}

// Occluder-table test of the hit points (hx, hy, hz)[k] toward the light of
// row lp (dir, e1, e2, org), the JAX kernel's dense cyl/ring occluders
// (megakernel.py:1153-1295).  The block first reduces the (u, v) rectangle
// and least tau of the samples in rectm (the lit ones) over all its threads;
// the table's entries whose light-space segment passes within radius +
// half-diagonal + eps of the rectangle's centre and whose far key exceeds
// that tau + eps are compacted into shared memory, OCB at a time, with their
// ray-independent terms, and each sample in testm is tested against them.
// The result (bit k: sample k blocked) is an OR, so the order in which the
// entries land in shared memory does not matter.  Every thread of the block
// must call it.
__device__ __forceinline__ uint32_t occ_blocked(
    const float* lp, const float4* __restrict__ occ, int nocc, float eps,
    uint32_t rectm, uint32_t testm, const float (&hx)[SG],
    const float (&hy)[SG], const float (&hz)[SG], float4* stage, float* red,
    int* scount) {
  float r[5] = {BIG, BIG, BIG, BIG, BIG};  // umin, -umax, vmin, -vmax, taumin
#pragma unroll
  for (int k = 0; k < SG; ++k) {
    if ((rectm >> k) & 1u) {
      const float u = hx[k] * lp[3] + hy[k] * lp[4] + hz[k] * lp[5] - lp[9];
      const float v = hx[k] * lp[6] + hy[k] * lp[7] + hz[k] * lp[8] - lp[10];
      const float tau = hx[k] * lp[0] + hy[k] * lp[1] + hz[k] * lp[2];
      r[0] = fminf(r[0], u);
      r[1] = fminf(r[1], -u);
      r[2] = fminf(r[2], v);
      r[3] = fminf(r[3], -v);
      r[4] = fminf(r[4], tau);
    }
  }
  block_min<5>(r, red);
  const float umin = r[0], umax = -r[1], vmin = r[2], vmax = -r[3];
  if (!(umax >= umin)) return 0u;  // no lit sample in the block (uniform)
  const float ucx = 0.5f * (umin + umax), vcx = 0.5f * (vmin + vmax);
  const float du = umax - umin, dv = vmax - vmin;
  const float halfdiag = 0.5f * sqrtf(du * du + dv * dv);
  const float tgate = r[4] + eps;
  const float lx = lp[0], ly = lp[1], lz = lp[2];
  uint32_t hit = 0u;
  for (int b0 = 0; b0 < nocc; b0 += OCB) {
    __syncthreads();  // the previous batch's readers are done
    if (threadIdx.x == 0) *scount = 0;
    __syncthreads();
    const int i = b0 + (int)threadIdx.x;
    if (i < nocc) {
      const float4 a = occ[4 * (size_t)i];      // p, rad
      const float4 c = occ[4 * (size_t)i + 1];  // u0, v0, lateral pad, far key
      const float4 d = occ[4 * (size_t)i + 3];  // alen, u1, v1, alpha
      const float bx = d.y - c.x, by = d.z - c.y;
      const float wx = ucx - c.x, wy = vcx - c.y;
      float ts = (wx * bx + wy * by) / fmaxf(bx * bx + by * by, 1e-12f);
      ts = fminf(fmaxf(ts, 0.0f), 1.0f);
      const float dxs = wx - ts * bx, dys = wy - ts * by;
      const float lim = c.z + halfdiag + eps;
      if (a.w > 0.0f && dxs * dxs + dys * dys <= lim * lim && c.w > tgate) {
        const float4 b = occ[4 * (size_t)i + 2];  // axis, typ
        const float dda = b.x * lx + b.y * ly + b.z * lz;
        const float dpx = lx - dda * b.x, dpy = ly - dda * b.y,
                    dpz = lz - dda * b.z;
        const float a2 = dpx * dpx + dpy * dpy + dpz * dpz;
        const int s = atomicAdd(scount, 1);
        stage[4 * s] = a;
        stage[4 * s + 1] = b;
        stage[4 * s + 2] = make_float4(dpx, dpy, dpz, a2);
        stage[4 * s + 3] =
            make_float4(dda, 1.0f / (a2 > 1e-12f ? a2 : 1.0f), d.x, 0.0f);
      }
    }
    __syncthreads();
    const int n = *scount;
    uint32_t todo = testm & ~hit;
    for (int j = 0; j < n && todo; ++j) {
      const float4 a = stage[4 * j], b = stage[4 * j + 1];
      const float4 e = stage[4 * j + 2], f = stage[4 * j + 3];
#pragma unroll
      for (int k = 0; k < SG; ++k) {
        if ((todo >> k) & 1u) {
          const float ocx = hx[k] - a.x, ocy = hy[k] - a.y, ocz = hz[k] - a.z;
          const float oca = ocx * b.x + ocy * b.y + ocz * b.z;
          bool occ_k = false;
          if (b.w == 1.0f) {
            const float opx = ocx - oca * b.x, opy = ocy - oca * b.y,
                        opz = ocz - oca * b.z;
            const float bq = opx * e.x + opy * e.y + opz * e.z;
            const float cq = opx * opx + opy * opy + opz * opz - a.w * a.w;
            const float disc = bq * bq - e.w * cq;
            if (disc >= 0.0f && e.w > 1e-12f) {
              const float sq = sqrtf(disc);
              const float t1 = (-bq - sq) * f.y;
              const float t2 = (-bq + sq) * f.y;
              const float s1 = oca + t1 * f.x;
              const float s2 = oca + t2 * f.x;
              occ_k = (t1 > eps && s1 >= 0.0f && s1 <= f.z) ||
                      (t2 > eps && s2 >= 0.0f && s2 <= f.z);
            }
          } else if (b.w == 2.0f && fabsf(f.x) > 1e-12f) {
            const float tr0 = -oca / f.x;
            const float rx = ocx + tr0 * lx, ry = ocy + tr0 * ly,
                        rz = ocz + tr0 * lz;
            occ_k = tr0 > eps && rx * rx + ry * ry + rz * rz <= a.w * a.w;
          }
          if (occ_k) todo &= ~(1u << k);
        }
      }
    }
    hit |= testm & ~todo;
  }
  return hit;
}

// The occluder-table test of translucent scenes: as occ_blocked, but each
// sample k of testm has its transmission tr[k] multiplied by 1 - alpha (0 at
// alpha >= 0.99999) of every entry that blocks it, and leaves the test once
// it is 0.  The entries that pass the cull are staged in the table's order
// (a ballot and a prefix over the warps, wcnt holding P / 32 ints), so each
// product is taken in ascending entry order, as the plain version takes it.
// Every thread of the block must call it.
__device__ __forceinline__ void occ_trans(
    const float* lp, const float4* __restrict__ occ, int nocc, float eps,
    uint32_t rectm, uint32_t testm, const float (&hx)[SG],
    const float (&hy)[SG], const float (&hz)[SG], float (&tr)[SG],
    float4* stage, float* red, int* wcnt) {
  float r[5] = {BIG, BIG, BIG, BIG, BIG};  // umin, -umax, vmin, -vmax, taumin
#pragma unroll
  for (int k = 0; k < SG; ++k) {
    if ((rectm >> k) & 1u) {
      const float u = hx[k] * lp[3] + hy[k] * lp[4] + hz[k] * lp[5] - lp[9];
      const float v = hx[k] * lp[6] + hy[k] * lp[7] + hz[k] * lp[8] - lp[10];
      const float tau = hx[k] * lp[0] + hy[k] * lp[1] + hz[k] * lp[2];
      r[0] = fminf(r[0], u);
      r[1] = fminf(r[1], -u);
      r[2] = fminf(r[2], v);
      r[3] = fminf(r[3], -v);
      r[4] = fminf(r[4], tau);
    }
  }
  block_min<5>(r, red);
  const float umin = r[0], umax = -r[1], vmin = r[2], vmax = -r[3];
  if (!(umax >= umin)) return;  // no lit sample in the block (uniform)
  const float ucx = 0.5f * (umin + umax), vcx = 0.5f * (vmin + vmax);
  const float du = umax - umin, dv = vmax - vmin;
  const float halfdiag = 0.5f * sqrtf(du * du + dv * dv);
  const float tgate = r[4] + eps;
  const float lx = lp[0], ly = lp[1], lz = lp[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b0 = 0; b0 < nocc; b0 += OCB) {
    const int i = b0 + (int)threadIdx.x;
    bool keep = false;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), d = a;
    if (i < nocc) {
      a = occ[4 * (size_t)i];                   // p, rad
      const float4 c = occ[4 * (size_t)i + 1];  // u0, v0, lateral pad, far key
      d = occ[4 * (size_t)i + 3];               // alen, u1, v1, alpha
      const float bx = d.y - c.x, by = d.z - c.y;
      const float wx = ucx - c.x, wy = vcx - c.y;
      float ts = (wx * bx + wy * by) / fmaxf(bx * bx + by * by, 1e-12f);
      ts = fminf(fmaxf(ts, 0.0f), 1.0f);
      const float dxs = wx - ts * bx, dys = wy - ts * by;
      const float lim = c.z + halfdiag + eps;
      keep = a.w > 0.0f && dxs * dxs + dys * dys <= lim * lim && c.w > tgate;
    }
    const uint32_t ball = __ballot_sync(0xffffffffu, keep);
    __syncthreads();  // the previous batch's readers are done
    if (lane == 0) wcnt[warp] = __popc(ball);
    __syncthreads();
    int base = 0, n = 0;
#pragma unroll
    for (int w = 0; w < P / 32; ++w) {
      const int cw = wcnt[w];
      base += w < warp ? cw : 0;
      n += cw;
    }
    if (keep) {
      const int s = base + __popc(ball & ((1u << lane) - 1u));
      const float4 b = occ[4 * (size_t)i + 2];  // axis, typ
      const float dda = b.x * lx + b.y * ly + b.z * lz;
      const float dpx = lx - dda * b.x, dpy = ly - dda * b.y,
                  dpz = lz - dda * b.z;
      const float a2 = dpx * dpx + dpy * dpy + dpz * dpz;
      stage[4 * s] = a;
      stage[4 * s + 1] = b;
      stage[4 * s + 2] = make_float4(dpx, dpy, dpz, a2);
      stage[4 * s + 3] = make_float4(dda, 1.0f / (a2 > 1e-12f ? a2 : 1.0f),
                                     d.x, d.w >= 0.99999f ? 0.0f : 1.0f - d.w);
    }
    __syncthreads();
    uint32_t todo = 0u;
#pragma unroll
    for (int k = 0; k < SG; ++k)
      if (((testm >> k) & 1u) && tr[k] > 0.0f) todo |= 1u << k;
    for (int j = 0; j < n && todo; ++j) {
      const float4 a = stage[4 * j], b = stage[4 * j + 1];
      const float4 e = stage[4 * j + 2], f = stage[4 * j + 3];
#pragma unroll
      for (int k = 0; k < SG; ++k) {
        if (((todo >> k) & 1u) &&
            stage_occludes(a, b, e, f, hx[k], hy[k], hz[k], lx, ly, lz, eps)) {
          tr[k] = tr[k] * f.w;
          if (!(tr[k] > 0.0f)) todo &= ~(1u << k);
        }
      }
    }
  }
}

// Fields of a ray's peel state, 8 floats per (sample, pixel): field f of
// sample s at st[(f * S + s) * P + pixel].
enum { ST_OX, ST_OY, ST_OZ, ST_W, ST_AR, ST_AG, ST_AB, ST_CUMT, ST_N };

// Two blocks an SM (at most 128 registers), but for the peel kernels
// without AO sky lights: their walks are few and their per-ray chunk tests
// would spill.
template <bool PERSP, bool SHADOWS, bool AO, bool OTHER, bool PEEL>
__global__ void __launch_bounds__(P, PEEL && !AO ? 1 : 2)
mega_render_kernel(const float* __restrict__ params,
                   const float* __restrict__ lparams, // (nlights, 16)
                   const float* __restrict__ chunks,  // (nb, nchunks, 8, CH)
                   const float* __restrict__ zmin,    // (nb, nchunks)
                   const float4* __restrict__ lrec,   // (M, 2) float4 rows
                   const int* __restrict__ loffs,     // (nlights, ncells)
                   const int* __restrict__ lcnt,      // (nlights, ncells)
                   const float* __restrict__ lkmax,   // (nlights, ncells)
                   const float4* __restrict__ orec,   // (M, 4) cyl/ring rows
                   const int* __restrict__ ooffs,     // (nb,) starts into orec
                   const int* __restrict__ ocnt,      // (nb,)
                   const float4* __restrict__ occ,    // (nlights, nocc, 4)
                   float* __restrict__ out,           // (ntiles, 3*P)
                   int tile0, int nchunks, int tiles_x, int S,
                   uint32_t seed, int grid_n, int nlights, int nocc,
                   float eps, float inv_s, int n_peel,
                   float* __restrict__ gstate) {  // PEEL: state, or null
  __shared__ float sp[64];
  __shared__ float slp[AO ? MAX_LIGHTS * 16 : 1];
  __shared__ float4 cand[2][CH];
  __shared__ float2 crr[2][CH];
  __shared__ float craw[4 * CH];
  __shared__ float red[2][NW];
  __shared__ float4 ostage[OTHER ? 4 * OCB : 1];
  __shared__ float ored[OTHER ? 5 * NW : 1];
  __shared__ int oscount;
  // walks queued per round: fewer where the cyl/ring stage takes the room
  constexpr int NQ = SHADOWS ? (OTHER ? WQ : 2 * WQ) : 1;
  __shared__ int q_off[NQ], q_cnt[NQ];
  __shared__ float q_u[NQ], q_v[NQ], q_te[NQ], q_tr[NQ];
  __shared__ short q_lng[NQ];
  __shared__ int q_wsum[NW], q_nlong, q_next;
  const WalkQueue wq{q_off, q_cnt, q_u, q_v, q_te, q_tr, q_lng, &q_nlong,
                     &q_next};
  float* dsm = nullptr;  // PEEL: the dynamic shared memory below
  if constexpr (PEEL) {
    extern __shared__ float dyn_smem[];
    dsm = dyn_smem;
  }

  const int tile = tile0 + blockIdx.x;
  const int pix = threadIdx.x;
  const int lane = pix & 31, warp = pix >> 5;
  if (pix < 64) sp[pix] = params[pix];
  if (AO)
    for (int i = pix; i < nlights * 16; i += P) slp[i] = lparams[i];
  __syncthreads();

  float* tout = out + (size_t)blockIdx.x * 3 * P;
  const float* tzmin = zmin + (size_t)tile * nchunks;
  const float bgr = sp[28], bgg = sp[29], bgb = sp[30];
  const int ocount = OTHER ? ocnt[tile] : 0;
  const float4* trec = orec + (OTHER ? 4 * (size_t)ooffs[tile] : 0);
  // a tile with no candidate at all is background
  if (!(tzmin[0] < BIG_DEPTH) && ocount == 0) {
    tout[pix] = bgr;
    tout[P + pix] = bgg;
    tout[2 * P + pix] = bgb;
    return;
  }

  const float ox = sp[0], oy = sp[1], oz = sp[2];
  const float llx = sp[3], lly = sp[4], llz = sp[5];
  const float iprx = sp[6], ipry = sp[7], iprz = sp[8];
  const float ipux = sp[9], ipuy = sp[10], ipuz = sp[11];
  const float vwx = sp[12], vwy = sp[13], vwz = sp[14];
  const float lx = sp[15], ly = sp[16], lz = sp[17];
  const float off = sp[37], ambient = sp[38], lightcol = sp[27];

  const float txf = (float)(tile % tiles_x);
  const float tyf = (float)(tile / tiles_x);
  const float sub_x = (float)(pix % TILE);
  const float sub_y = (float)(pix / TILE);
  const float* tchunks = chunks + (size_t)tile * nchunks * 8 * CH;

  // PEEL: the ordered table test's warp counts, each sky light's
  // transmission at sample 0's hit (one row of P per light l >= 1), then the
  // rays' peel state unless the caller gave it a device buffer
  int* wcnt = reinterpret_cast<int*>(dsm);
  float* aot = dsm + NW;
  const size_t SP = (size_t)S * P;
  float* st = gstate ? gstate + (size_t)blockIdx.x * ST_N * SP
                     : dsm + NW + (size_t)(nlights - 1) * P;
  const bool multi = PEEL && n_peel > 1;
  const bool camo = PERSP && !multi;  // every ray starts at the camera
  if (PEEL) {
    for (int s = 0; s < S; ++s) {
      const size_t o = (size_t)s * P + pix;
      st[ST_W * SP + o] = 1.0f;
      st[ST_AR * SP + o] = st[ST_AG * SP + o] = st[ST_AB * SP + o] = 0.0f;
      st[ST_CUMT * SP + o] = 0.0f;
    }
  }

  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  uint64_t aoblocked = 0;  // bit l: sky light l blocked at sample 0's hit
  int rsel = 0;            // block_max's slot
  const int ngroups = (S + SG - 1) / SG;
  const int npeel = PEEL ? n_peel : 1;
  for (int peel = 0; peel < npeel; ++peel) {
  if (PEEL && peel > 0) {
    // a later peel runs while some ray of the tile keeps a weight > 1e-4
    float wmax = 0.0f;
    for (int s = 0; s < S; ++s)
      wmax = fmaxf(wmax, st[ST_W * SP + (size_t)s * P + pix]);
    if (!(block_max(wmax, red, rsel) > 1e-4f)) break;  // uniform
  }
  for (int g = 0; g < ngroups; ++g) {
    const int s0 = g * S / ngroups;
    const int ns = (g + 1) * S / ngroups - s0;

    // chunk 0 is fetched while the rays are made; the barrier of the block
    // max below publishes it
    if (nchunks > 0) chunk_fetch(tchunks, craw);

    // ---- ray generation --------------------------------------------------
    float rdx[SG], rdy[SG], rdz[SG], rox[SG], roy[SG], roz[SG];
    float tcap[SG], bt[SG];
    float cum[SG];  // with n_peel > 1: each ray's camera depth so far
    int bidx[SG];
    float need = -BIG;
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      bt[k] = BIG;
      bidx[k] = -1;
      tcap[k] = -BIG;
      rdx[k] = rdy[k] = rdz[k] = rox[k] = roy[k] = roz[k] = 0.0f;
      if (k < ns) {
        const int s = s0 + k;
        float jx, jy;
        hash_jitter((uint32_t)tile, (uint32_t)s, seed, (uint32_t)pix, jx, jy);
        const float nz = s > 0 ? 1.0f : 0.0f;
        const float x = txf * (float)TILE + sub_x + off + jx * nz;
        const float y = tyf * (float)TILE + sub_y + off + jy * nz;
        float dx = llx + x * iprx + y * ipux;
        float dy = lly + x * ipry + y * ipuy;
        float dz = llz + x * iprz + y * ipuz;
        if (PERSP) {
          const float inv = rsqrtf(dx * dx + dy * dy + dz * dz);
          dx *= inv;
          dy *= inv;
          dz *= inv;
          rox[k] = ox;
          roy[k] = oy;
          roz[k] = oz;
        } else {
          rox[k] = dx;
          roy[k] = dy;
          roz[k] = dz;
          dx = vwx;
          dy = vwy;
          dz = vwz;
        }
        if (PEEL && peel > 0) {
          // past the previous peel's hit point, by eps along the ray
          const float* o = st + (size_t)s * P + pix;
          rox[k] = o[ST_OX * SP] + eps * dx;
          roy[k] = o[ST_OY * SP] + eps * dy;
          roz[k] = o[ST_OZ * SP] + eps * dz;
        }
        if (multi) cum[k] = st[ST_CUMT * SP + (size_t)s * P + pix];
        rdx[k] = dx;
        rdy[k] = dy;
        rdz[k] = dz;
        // ray-AABB exit bounds the early-termination test
        float n0, f0, n1, f1, n2, f2;
        axis_exit(rox[k], dx, sp[31], sp[34], n0, f0);
        axis_exit(roy[k], dy, sp[32], sp[35], n1, f1);
        axis_exit(roz[k], dz, sp[33], sp[36], n2, f2);
        const float tnear = fmaxf(fmaxf(n0, n1), n2);
        const float tfar = fminf(fminf(f0, f1), f2);
        tcap[k] = tfar >= fmaxf(tnear, 0.0f) ? tfar : -BIG;
        need = fmaxf(need, multi ? tcap[k] + cum[k] : tcap[k]);
      }
    }
    if (nchunks > 0) chunk_stage(craw, cand[0], crr[0], camo, ox, oy, oz);
    need = block_max(need, red, rsel);

    // ---- front-to-back chunk walk, chunk c + 1 in flight while c is tested
    int cbuf = 0;  // the buffer that holds chunk c
    for (int c = 0; c < nchunks; ++c) {
      if (!(tzmin[c] < need)) break;  // uniform across the block
      // need only falls, so a chunk it does not reach now is never tested
      const bool ahead = c + 1 < nchunks && tzmin[c + 1] < need;
      if (ahead) chunk_fetch(tchunks + (size_t)(c + 1) * 8 * CH, craw);
      // the stable discriminant r^2 - |w|^2, w = oc - b d (tracer.py:_sph):
      // b^2 - (|oc|^2 - r^2) loses about four digits in float32 with the
      // camera hundreds of Angstrom away, enough to pick another sphere at a
      // seam or a silhouette and to put the hit point past eps inside its
      // sphere.  A candidate takes it only where it can win: no root of it
      // lies before -b - sqrt(r^2) (sqrt(disc) <= sqrt(r^2), and rounding
      // keeps the order), so one that starts at or past the best t cannot
      // beat it; camera rays also pass the gate first.
      const float4* cc = cand[cbuf];
      const float2* cr = crr[cbuf];
      for (int j = 0; j < CH; ++j) {
        const float4 q = cc[j];
        const float2 rr = cr[j];
#pragma unroll
        for (int k = 0; k < SG; ++k) {
          if (k < ns) {
            float ocx = q.x, ocy = q.y, ocz = q.z;
            if (!camo) {
              ocx = rox[k] - q.x;
              ocy = roy[k] - q.y;
              ocz = roz[k] - q.z;
            }
            const float b = ocx * rdx[k] + ocy * rdy[k] + ocz * rdz[k];
            if (-b - rr.y < bt[k] && (!camo || b * b >= q.w)) {
              const float wx = ocx - b * rdx[k], wy = ocy - b * rdy[k],
                          wz = ocz - b * rdz[k];
              const float disc = rr.x - (wx * wx + wy * wy + wz * wz);
              if (disc >= 0.0f) {
                const float t = sphere_root(b, disc, eps);
                if (t < bt[k]) {
                  bt[k] = t;
                  bidx[k] = c * CH + j;
                }
              }
            }
          }
        }
      }
      float ln = -BIG;
#pragma unroll
      for (int k = 0; k < SG; ++k)
        if (k < ns)
          ln = fmaxf(ln, multi ? fminf(bt[k], tcap[k]) + cum[k]
                               : fminf(bt[k], tcap[k]));
      if (ahead) chunk_stage(craw, cand[cbuf ^ 1], crr[cbuf ^ 1], camo, ox, oy, oz);
      // one barrier: the block max, chunk c + 1 published, chunk c retired
      need = block_max(ln, red, rsel);
      cbuf ^= 1;
    }

    if constexpr (OTHER) {
      // ---- dense cyl/ring pass over the tile's records, in slot order -------
      for (int b0 = 0; b0 < ocount; b0 += OCB) {
        const int n = min(OCB, ocount - b0);
        __syncthreads();  // the previous batch's readers are done
        if (pix < n) {
          const float4* rp = trec + 4 * (size_t)(b0 + pix);
          const float4 a = rp[0], ax = rp[2];  // (p, rad), (axis, typ)
          const float alen = rp[3].x;
          if (camo) {
            const float ocx = ox - a.x, ocy = oy - a.y, ocz = oz - a.z;
            const float oca = ocx * ax.x + ocy * ax.y + ocz * ax.z;
            const float opx = ocx - oca * ax.x, opy = ocy - oca * ax.y,
                        opz = ocz - oca * ax.z;
            const float cq = opx * opx + opy * opy + opz * opz - a.w * a.w;
            ostage[4 * pix] = make_float4(ocx, ocy, ocz, oca);
            ostage[4 * pix + 2] = make_float4(opx, opy, opz, cq);
          } else {
            ostage[4 * pix] = a;
          }
          ostage[4 * pix + 1] = ax;
          ostage[4 * pix + 3] = make_float4(a.w, alen, 0.0f, 0.0f);
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
          const float4 q0 = ostage[4 * j], ax = ostage[4 * j + 1];
          const float4 q3 = ostage[4 * j + 3];
          float4 q2 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (camo) q2 = ostage[4 * j + 2];
#pragma unroll
          for (int k = 0; k < SG; ++k) {
            if (k < ns) {
              float t;
              if (camo) {
                t = cylring_t(q0.x, q0.y, q0.z, q0.w, q2.x, q2.y, q2.z, q2.w,
                              ax, q3.x, q3.y, rdx[k], rdy[k], rdz[k], eps);
              } else {
                const float ocx = rox[k] - q0.x, ocy = roy[k] - q0.y,
                            ocz = roz[k] - q0.z;
                const float oca = ocx * ax.x + ocy * ax.y + ocz * ax.z;
                const float opx = ocx - oca * ax.x, opy = ocy - oca * ax.y,
                            opz = ocz - oca * ax.z;
                const float cq = opx * opx + opy * opy + opz * opz - q3.x * q3.x;
                t = cylring_t(ocx, ocy, ocz, oca, opx, opy, opz, cq, ax, q3.x,
                              q3.y, rdx[k], rdy[k], rdz[k], eps);
              }
              if (t < bt[k]) {
                bt[k] = t;
                bidx[k] = OTHER_BIT | (b0 + j);
              }
            }
          }
        }
      }
    }

    // ---- surfaces: hit point -> ro*, facing normal -> rd* ------------------
    uint32_t missm = 0u;
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      if (k < ns) {
        float cx = 0.f, cy = 0.f, cz = 0.f, rw = 0.f;
        float4 ax = make_float4(0.f, 0.f, 0.f, 0.f);  // sphere: typ 0
        if (OTHER && bidx[k] >= OTHER_BIT) {
          const float4* rp = trec + 4 * (size_t)(bidx[k] - OTHER_BIT);
          const float4 a = rp[0];
          cx = a.x;
          cy = a.y;
          cz = a.z;
          rw = a.w;
          ax = rp[2];
        } else if (bidx[k] >= 0) {
          const float* rp = tchunks + (size_t)(bidx[k] / CH) * 8 * CH + (bidx[k] % CH);
          cx = rp[0];
          cy = rp[CH];
          cz = rp[2 * CH];
          rw = rp[3 * CH];
        }
        const bool missed = (bt[k] >= BIG_DEPTH) || (rw <= 0.0f);
        const float tsafe = missed ? 0.0f : bt[k];
        float hx = rox[k] + tsafe * rdx[k];
        float hy = roy[k] + tsafe * rdy[k];
        float hz = roz[k] + tsafe * rdz[k];
        float nx = hx - cx, ny = hy - cy, nz = hz - cz;
        if (ax.w == 1.0f) {  // cylinder: radial minus the axis part
          const float sax = nx * ax.x + ny * ax.y + nz * ax.z;
          nx = nx - sax * ax.x;
          ny = ny - sax * ax.y;
          nz = nz - sax * ax.z;
        } else if (ax.w == 2.0f) {  // ring: the plane normal
          nx = ax.x;
          ny = ax.y;
          nz = ax.z;
        }
        const float inv = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
        nx *= inv;
        ny *= inv;
        nz *= inv;
        if (ax.w == 0.0f && !missed) {
          // a sphere's hit point back on its surface along the normal: o +
          // t d carries the rounding of t and of the camera's distance (up
          // to 5e-5 A at 190 A), which a sky light's walk at a grazing
          // angle reads as the sphere shadowing itself
          hx = cx + rw * nx;
          hy = cy + rw * ny;
          hz = cz + rw * nz;
        }
        const float facing = nx * rdx[k] + ny * rdy[k] + nz * rdz[k];
        const float flip = facing > 0.0f ? -1.0f : 1.0f;
        rox[k] = hx;
        roy[k] = hy;
        roz[k] = hz;
        rdx[k] = nx * flip;
        rdy[k] = ny * flip;
        rdz[k] = nz * flip;
        if (missed) missm |= 1u << k;
      }
    }

    // ---- the group's cell walks: the primary light per sample, on sample 0
    // the AO sky lights.  tr[k] is sample k's transmission toward the
    // primary light (0 or 1 without PEEL); with PEEL, aot holds each sky
    // light's at sample 0, without it aoblocked the blocked ones' bits.
    uint32_t litm = 0u, blkm = 0u;
    float tr[SG];
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      tr[k] = 1.0f;
      if (k < ns && !((missm >> k) & 1u) &&
          rdx[k] * lx + rdy[k] * ly + rdz[k] * lz > MINCONTRIB)
        litm |= 1u << k;
    }
    const bool ao0 = AO && SHADOWS && g == 0;
    const bool miss0 = missm & 1u;
    if constexpr (SHADOWS) {
      // the walks this thread queues: primary bits k, sky-light bits l
      uint32_t pm = 0u;
      uint64_t am = 0ull;
      float u, v, te;
#pragma unroll
      for (int k = 0; k < SG; ++k) {
        if ((litm >> k) & 1u) {
          const int cell = light_cell(sp + 15, rox[k], roy[k], roz[k], grid_n,
                                      0, eps, u, v, te);
          if (cell_gate(lcnt, lkmax, cell, te)) pm |= 1u << k;
        }
      }
      if (ao0) {
        for (int l = 1; l < nlights; ++l) {
          const float* lp = slp + 16 * l;
          if (PEEL) aot[(size_t)(l - 1) * P + pix] = 1.0f;
          const float il = rdx[0] * lp[0] + rdy[0] * lp[1] + rdz[0] * lp[2];
          if (il > MINCONTRIB && !miss0) {
            const int cell = light_cell(lp, rox[0], roy[0], roz[0], grid_n,
                                        l * grid_n * grid_n, eps, u, v, te);
            if (cell_gate(lcnt, lkmax, cell, te)) am |= 1ull << l;
          }
        }
      }
      // each thread's first entry: an exclusive prefix over the block
      const int mine = __popc(pm) + __popcll(am);
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane == 31) q_wsum[warp] = incl;
      __syncthreads();
      int first = incl - mine, total = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int t = q_wsum[w];
        first += w < warp ? t : 0;
        total += t;
      }
      // rounds of NQ walks (total is uniform); a round's entries stay until
      // their owners have read the results
      for (int r0 = 0; r0 < total; r0 += NQ) {
        if (r0 > 0) __syncthreads();
        int j = first;
        if (first < r0 + NQ && first + mine > r0) {
#pragma unroll
          for (int k = 0; k < SG; ++k) {
            if ((pm >> k) & 1u) {
              if (j >= r0 && j < r0 + NQ)
                queue_walk(wq, j - r0, sp + 15, rox[k], roy[k], roz[k],
                           grid_n, 0, eps, loffs, lcnt);
              ++j;
            }
          }
          for (int l = 1; l < nlights && am >> l; ++l) {
            if ((am >> l) & 1ull) {
              if (j >= r0 && j < r0 + NQ)
                queue_walk(wq, j - r0, slp + 16 * l, rox[0], roy[0], roz[0],
                           grid_n, l * grid_n * grid_n, eps, loffs, lcnt);
              ++j;
            }
          }
        }
        if (pix == 0) q_nlong = q_next = 0;
        __syncthreads();
        walk_round<PEEL>(lrec, wq, min(NQ, total - r0));
        j = first;
#pragma unroll
        for (int k = 0; k < SG; ++k) {
          if ((pm >> k) & 1u) {
            if (j >= r0 && j < r0 + NQ) {
              tr[k] = q_tr[j - r0];
              if (!PEEL && tr[k] == 0.0f) blkm |= 1u << k;
            }
            ++j;
          }
        }
        for (int l = 1; l < nlights && am >> l; ++l) {
          if ((am >> l) & 1ull) {
            if (j >= r0 && j < r0 + NQ) {
              const float t = q_tr[j - r0];
              if (PEEL)
                aot[(size_t)(l - 1) * P + pix] = t;
              else if (t == 0.0f)
                aoblocked |= 1ull << l;
            }
            ++j;
          }
        }
      }
    }

    // ---- occluder tables: with PEEL for the points with a transmission
    // > 0, else for those their cell walk left clear ----------------------
    if constexpr (PEEL && OTHER) {
      if (SHADOWS && nocc > 0) {
        uint32_t testm = 0u;
#pragma unroll
        for (int k = 0; k < SG; ++k)
          if (tr[k] > 0.0f) testm |= litm & (1u << k);
        occ_trans(sp + 15, occ, nocc, eps, litm, testm, rox, roy, roz, tr,
                  ostage, ored, wcnt);
        if (ao0) {
          for (int l = 1; l < nlights; ++l) {
            const float* lp = slp + 16 * l;
            const float il = rdx[0] * lp[0] + rdy[0] * lp[1] + rdz[0] * lp[2];
            const uint32_t lit0 = (il > MINCONTRIB && !miss0) ? 1u : 0u;
            float t0[SG];
#pragma unroll
            for (int k = 0; k < SG; ++k) t0[k] = 1.0f;
            t0[0] = aot[(size_t)(l - 1) * P + pix];
            occ_trans(lp, occ + 4 * (size_t)l * nocc, nocc, eps, lit0,
                      t0[0] > 0.0f ? lit0 : 0u, rox, roy, roz, t0, ostage,
                      ored, wcnt);
            aot[(size_t)(l - 1) * P + pix] = t0[0];
          }
        }
      }
    } else if constexpr (OTHER) {
      if (SHADOWS && nocc > 0) {
        blkm |= occ_blocked(sp + 15, occ, nocc, eps, litm, litm & ~blkm, rox,
                            roy, roz, ostage, ored, &oscount);
        if (ao0) {
          for (int l = 1; l < nlights; ++l) {
            const float* lp = slp + 16 * l;
            const float il = rdx[0] * lp[0] + rdy[0] * lp[1] + rdz[0] * lp[2];
            const uint32_t lit0 = (il > MINCONTRIB && !miss0) ? 1u : 0u;
            const uint32_t clear0 = lit0 & ~(uint32_t)((aoblocked >> l) & 1ull);
            if (occ_blocked(lp, occ + 4 * (size_t)l * nocc, nocc, eps, lit0,
                            clear0, rox, roy, roz, ostage, ored, &oscount))
              aoblocked |= 1ull << l;
          }
        }
      }
    }

    // ---- shading, per sample, lights in order ------------------------------
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      if (k < ns) {
        float cr = 0.f, cg = 0.f, cb = 0.f, ca = 0.f;
        if (OTHER && bidx[k] >= OTHER_BIT) {
          const float4 c = trec[4 * (size_t)(bidx[k] - OTHER_BIT) + 1];
          cr = c.x;
          cg = c.y;
          cb = c.z;
          ca = c.w;
        } else if (bidx[k] >= 0) {
          const float* rp = tchunks + (size_t)(bidx[k] / CH) * 8 * CH + (bidx[k] % CH);
          cr = rp[4 * CH];
          cg = rp[5 * CH];
          cb = rp[6 * CH];
          ca = rp[7 * CH];
        }
        const bool missed = (missm >> k) & 1u;
        const float nx = rdx[k], ny = rdy[k], nz = rdz[k];
        const float inten = nx * lx + ny * ly + nz * lz;
        const float lit = ((litm >> k) & 1u) ? 1.0f : 0.0f;
        const float filt = PEEL ? tr[k] : (((blkm >> k) & 1u) ? 0.0f : 1.0f);
        float sh = lit * inten * lightcol * filt;
        if (AO) {
          for (int l = 1; l < nlights; ++l) {
            const float* lp = slp + 16 * l;
            const float il = nx * lp[0] + ny * lp[1] + nz * lp[2];
            const float ll = (il > MINCONTRIB && !missed) ? 1.0f : 0.0f;
            float fl = ((aoblocked >> l) & 1ull) ? 0.0f : 1.0f;
            if (PEEL) fl = SHADOWS ? aot[(size_t)(l - 1) * P + pix] : 1.0f;
            sh = sh + ll * il * lp[12] * fl;
          }
        }
        const float shade = 0.8f * sh + ambient;
        if constexpr (PEEL) {
          // composite: the sums gain W a c, W becomes W (1 - a), and the
          // next peel starts from the hit point
          float* o = st + (size_t)(s0 + k) * P + pix;
          const float w = o[ST_W * SP];
          const float a = missed ? 1.0f : ca;
          o[ST_AR * SP] = o[ST_AR * SP] + w * a * (missed ? bgr : cr * shade);
          o[ST_AG * SP] = o[ST_AG * SP] + w * a * (missed ? bgg : cg * shade);
          o[ST_AB * SP] = o[ST_AB * SP] + w * a * (missed ? bgb : cb * shade);
          o[ST_W * SP] = w * (1.0f - a);
          if (multi)
            o[ST_CUMT * SP] = o[ST_CUMT * SP] + (missed ? 0.0f : bt[k]) + eps;
          o[ST_OX * SP] = rox[k];
          o[ST_OY * SP] = roy[k];
          o[ST_OZ * SP] = roz[k];
        } else {
          ar = ar + (missed ? bgr : cr * shade);
          ag = ag + (missed ? bgg : cg * shade);
          ab = ab + (missed ? bgb : cb * shade);
        }
      }
    }
  }
  }  // peels
  if constexpr (PEEL) {
    // the peeled sums plus the residual weight seeing the background
    for (int s = 0; s < S; ++s) {
      const float* o = st + (size_t)s * P + pix;
      const float w = o[ST_W * SP];
      ar = ar + o[ST_AR * SP] + w * bgr;
      ag = ag + o[ST_AG * SP] + w * bgg;
      ab = ab + o[ST_AB * SP] + w * bgb;
    }
  }
  tout[pix] = ar * inv_s;
  tout[P + pix] = ag * inv_s;
  tout[2 * P + pix] = ab * inv_s;
}

// Dynamic shared memory of a PEEL launch: warp counts, sky-light rows, and
// the peel state unless it lives in a device buffer.
size_t peel_smem(int S, int nlights, bool gstate) {
  return sizeof(float) * (NW + (size_t)(nlights - 1) * P +
                          (gstate ? 0 : (size_t)ST_N * S * P));
}

struct Args {
  const float *params, *lparams, *chunks, *zmin, *lrec;
  const int *loffs, *lcnt;
  const float* lkmax;
  const float* orec;
  const int *ooffs, *ocnt;
  const float* occ;
  float* out;
  int ntiles, tile0, nchunks, tiles_x, S;
  uint32_t seed;
  int grid_n, nlights, nocc;
  float eps, inv_s;
  int n_peel;
  float* gstate;
};

template <bool PERSP, bool SHADOWS, bool AO, bool OTHER, bool PEEL>
cudaError_t launch(cudaStream_t st, const Args& a) {
  auto kernel = mega_render_kernel<PERSP, SHADOWS, AO, OTHER, PEEL>;
  const size_t dyn = PEEL ? peel_smem(a.S, a.nlights, a.gstate != nullptr) : 0;
  if (dyn > 0) {  // static + dynamic past 48 KB needs the opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.ntiles, P, dyn, st>>>(
      a.params, a.lparams, a.chunks, a.zmin,
      reinterpret_cast<const float4*>(a.lrec), a.loffs, a.lcnt, a.lkmax,
      reinterpret_cast<const float4*>(a.orec), a.ooffs, a.ocnt,
      reinterpret_cast<const float4*>(a.occ), a.out, a.tile0, a.nchunks,
      a.tiles_x, a.S, a.seed, a.grid_n, a.nlights, a.nocc, a.eps, a.inv_s,
      a.n_peel, a.gstate);
  return cudaGetLastError();
}

// Registers, local (spill) bytes and static shared bytes of one variant, and
// the blocks an SM holds at once with dyn bytes of dynamic shared memory.
template <bool PERSP, bool SHADOWS, bool AO, bool OTHER, bool PEEL>
cudaError_t attrs(size_t dyn, int* out) {
  auto kernel = mega_render_kernel<PERSP, SHADOWS, AO, OTHER, PEEL>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  if (dyn > 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
    if (e != cudaSuccess) return e;
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, P, dyn);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return e;
}

struct Variant {
  cudaError_t (*launch)(cudaStream_t, const Args&);
  cudaError_t (*attrs)(size_t, int*);
};

template <bool PERSP, bool SHADOWS, bool AO, bool OTHER, bool PEEL>
Variant variant() {
  return {&launch<PERSP, SHADOWS, AO, OTHER, PEEL>,
          &attrs<PERSP, SHADOWS, AO, OTHER, PEEL>};
}

template <bool PERSP, bool OTHER, bool PEEL>
Variant pick(bool shadows, bool ao) {
  if (shadows)
    return ao ? variant<PERSP, true, true, OTHER, PEEL>()
              : variant<PERSP, true, false, OTHER, PEEL>();
  return ao ? variant<PERSP, false, true, OTHER, PEEL>()
            : variant<PERSP, false, false, OTHER, PEEL>();
}

Variant pick(bool perspective, bool shadows, bool ao, bool other, bool peel) {
  if (other)
    return peel ? (perspective ? pick<true, true, true>(shadows, ao)
                               : pick<false, true, true>(shadows, ao))
                : (perspective ? pick<true, true, false>(shadows, ao)
                               : pick<false, true, false>(shadows, ao));
  return peel ? (perspective ? pick<true, false, true>(shadows, ao)
                             : pick<false, false, true>(shadows, ao))
              : (perspective ? pick<true, false, false>(shadows, ao)
                             : pick<false, false, false>(shadows, ao));
}

}  // namespace

// Launches the kernel on `stream` over tiles [tile0, tile0 + ntiles) and
// writes their rows to out[0 .. ntiles); returns cudaGetLastError(), or
// cudaErrorInvalidValue when nlights is outside [1, MAX_LIGHTS] or a peel
// launch has n_peel < 1.
// lparams holds nlights rows of 16 floats (row 0 is read from params);
// lrec must be 16-byte aligned (M, 8) rows [cu, cv, ck, r, key, alpha, 0, 0];
// loffs, lcnt and lkmax hold nlights x grid_n^2 cells, light after light.
// With other != 0, orec holds the tiles' cyl/ring records as 16-byte aligned
// (M, 16) rows [p, rad, rgba, axis, typ, alen, 0, 0, 0], tile t's at rows
// ooffs[t] .. ooffs[t] + ocnt[t] in slot order, and occ the lights' occluder
// tables (nlights, nocc, 16), rows [p, rad, u0, v0, pad, key, axis, typ,
// alen, u1, v1, alpha]; nocc = 0 tests no occluder.  With peel != 0 the
// frame is peeled n_peel times (n_peel = 1: the one composited peel of
// peel1); state is null to keep the rays' peel state in shared memory, or a
// device buffer of ntiles x 8 x S x 256 floats.
extern "C" int mega_render_launch(const float* params, const float* lparams,
                                  const float* chunks, const float* zmin,
                                  const float* lrec, const int* loffs,
                                  const int* lcnt, const float* lkmax,
                                  const float* orec, const int* ooffs,
                                  const int* ocnt, const float* occ,
                                  float* out, int ntiles, int tile0,
                                  int nchunks, int tiles_x, int S,
                                  unsigned int seed, int grid_n, int nlights,
                                  int nocc, float eps, float inv_s,
                                  int perspective, int shadows, int other,
                                  int peel, int n_peel, float* state,
                                  void* stream) {
  if (nlights < 1 || nlights > MAX_LIGHTS || nocc < 0 || (peel && n_peel < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{params, lparams, chunks, zmin, lrec, loffs, lcnt, lkmax,
               orec, ooffs, ocnt, occ, out, ntiles, tile0, nchunks, tiles_x,
               S, seed, grid_n, nlights, nocc, eps, inv_s, n_peel, state};
  const Variant v = pick(perspective != 0, shadows != 0, nlights > 1,
                         other != 0, peel != 0);
  return static_cast<int>(v.launch(static_cast<cudaStream_t>(stream), a));
}

// out[0..4) = registers, local bytes, static shared bytes and blocks an SM
// of the variant a launch with these flags, S and nlights picks (the peel
// state in shared memory); returns a CUDA error code.
extern "C" int mega_render_attrs(int perspective, int shadows, int ao,
                                 int other, int peel, int S, int nlights,
                                 int* out) {
  const Variant v = pick(perspective != 0, shadows != 0, ao != 0, other != 0,
                         peel != 0);
  return static_cast<int>(
      v.attrs(peel ? peel_smem(S, nlights, false) : 0, out));
}
