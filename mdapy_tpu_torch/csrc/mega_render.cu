// Hand CUDA kernel for the render pass of one frame: raygen with AA jitter,
// front-to-back sphere closest hit, Lambert shading, the primary light's
// shadow sweep, the ambient-occlusion sky lights and the AA mean, for opaque
// spheres.
//
// Replaces the sphere slice of the Pallas TPU kernel
// mdapy_tpu/render/megakernel.py:_mega_kernel (launched at :2051 by
// render_image_mega).  It computes what that kernel computes for the slice;
// it is not a block-by-block translation:
//   * one thread block per 16x16 screen tile, one thread per pixel, the AA
//     samples looped inside the thread in groups of up to SG (each group
//     shares one walk over the tile's candidate chunks);
//   * each (8, 128) candidate chunk is staged in shared memory, with the
//     ray-independent terms (o - c and |o - c|^2 - r^2 for perspective)
//     computed once per candidate; after each chunk a block-wide max of
//     min(best_t, tcap) decides the zmin early exit;
//   * ties in t keep the lowest slot of the earliest chunk, as the TPU
//     kernel's exclusive one-hot select does;
//   * the shadow sweep is per ray: a lit point walks its light-grid cell's
//     records in descending far-key order and stops at the first occluder or
//     once key <= tau + eps, after which no record can occlude;
//   * with ambient occlusion (the AO template flag) lights 1..L-1 are the
//     directional sky lights of the JAX package's fast AO.  As in its
//     ao_shared mode, their occlusion is tested on AA sample 0's hit point
//     only: while the first sample group is shaded, sample 0 walks each sky
//     light's cell records and keeps the result as one bit per light.  Every
//     sample then adds lit * n.L * lightcol * (1 - bit) for each light in
//     light order, with its own normal.  The light rows (L x 16 floats) sit
//     in shared memory.  Without AO the kernel is the one-light kernel.
//
// What bounds it on the card: per-ray sphere tests (about 10 fp32 operations
// each, ~128 per processed chunk) and the shadow walks, whose lengths vary
// from ray to ray and so diverge within a warp; with AO, sample 0 runs L-1
// more walks one after another.  Candidate records are read once per chunk
// per block, so device memory traffic is small next to the arithmetic.
// Later work: warp-cooperative shadow windows, sorting rays by light cell,
// persistent blocks.
//
// Built by mdapy_tpu_torch/render/_build.py with nvcc for sm_90a into a
// shared library with a plain C interface (ctypes).  It is compiled with
// -fmad=false so that a*b+c rounds twice, as the plain torch version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;   // pixels per tile = threads per block
constexpr int CH = 128;          // candidates per chunk
constexpr int SG = 8;            // most AA samples traced per chunk walk
constexpr int MAX_LIGHTS = 64;   // lights a launch takes (one mask bit each)
constexpr float BIG = 1e18f;
constexpr float BIG_DEPTH = 1e17f;
constexpr float MINCONTRIB = 1.0f / 512.0f;

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

// Block-wide max; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < P / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}

// True when a record of the point's light-grid cell blocks it: the cell's
// records run by descending far key, so the walk stops at the first occluder
// or once key <= tau + eps, after which no record can occlude.
__device__ __forceinline__ bool occluded(const float4* __restrict__ lrec,
                                         const int* __restrict__ loffs,
                                         const int* __restrict__ lcnt,
                                         const float* __restrict__ lkmax,
                                         int cell, float u, float v,
                                         float tau_eps) {
  const int cnt = lcnt[cell];
  if (!(cnt > 0 && lkmax[cell] > tau_eps)) return false;
  const float4* rp = lrec + 2 * (size_t)loffs[cell];
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

// Shadow test of hit point h toward the light of row lp (dir, e1, e2, org,
// inv_cell), whose cells start at cell0 in the stacked CSR arrays.
__device__ __forceinline__ bool light_blocked(const float* lp, float hx,
                                              float hy, float hz, int grid_n,
                                              int cell0, float eps,
                                              const float4* __restrict__ lrec,
                                              const int* __restrict__ loffs,
                                              const int* __restrict__ lcnt,
                                              const float* __restrict__ lkmax) {
  const float u = hx * lp[3] + hy * lp[4] + hz * lp[5] - lp[9];
  const float v = hx * lp[6] + hy * lp[7] + hz * lp[8] - lp[10];
  const float tau = hx * lp[0] + hy * lp[1] + hz * lp[2];
  const float gmax = (float)(grid_n - 1);
  const float gx = fminf(fmaxf(floorf(u * lp[11]), 0.0f), gmax);
  const float gy = fminf(fmaxf(floorf(v * lp[11]), 0.0f), gmax);
  const int cell = cell0 + (int)gy * grid_n + (int)gx;
  return occluded(lrec, loffs, lcnt, lkmax, cell, u, v, tau + eps);
}

template <bool PERSP, bool SHADOWS, bool AO>
__global__ void __launch_bounds__(P)
mega_render_kernel(const float* __restrict__ params,
                   const float* __restrict__ lparams, // (nlights, 16)
                   const float* __restrict__ chunks,  // (nb, nchunks, 8, CH)
                   const float* __restrict__ zmin,    // (nb, nchunks)
                   const float4* __restrict__ lrec,   // (M, 2) float4 rows
                   const int* __restrict__ loffs,     // (nlights, ncells)
                   const int* __restrict__ lcnt,      // (nlights, ncells)
                   const float* __restrict__ lkmax,   // (nlights, ncells)
                   float* __restrict__ out,           // (ntiles, 3*P)
                   int tile0, int nchunks, int tiles_x, int S,
                   uint32_t seed, int grid_n, int nlights, float eps,
                   float inv_s) {
  __shared__ float sp[64];
  __shared__ float slp[AO ? MAX_LIGHTS * 16 : 1];
  __shared__ float4 cand[CH];
  __shared__ float red[P / 32];

  const int tile = tile0 + blockIdx.x;
  const int pix = threadIdx.x;
  if (pix < 64) sp[pix] = params[pix];
  if (AO)
    for (int i = pix; i < nlights * 16; i += P) slp[i] = lparams[i];
  __syncthreads();

  float* tout = out + (size_t)blockIdx.x * 3 * P;
  const float* tzmin = zmin + (size_t)tile * nchunks;
  const float bgr = sp[28], bgg = sp[29], bgb = sp[30];
  // a tile with no candidate at all is background
  if (!(tzmin[0] < BIG_DEPTH)) {
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

  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  uint64_t aoblocked = 0;  // bit l: sky light l blocked at sample 0's hit
  const int ngroups = (S + SG - 1) / SG;
  for (int g = 0; g < ngroups; ++g) {
    const int s0 = g * S / ngroups;
    const int ns = (g + 1) * S / ngroups - s0;

    // ---- ray generation --------------------------------------------------
    float rdx[SG], rdy[SG], rdz[SG], rox[SG], roy[SG], roz[SG];
    float tcap[SG], bt[SG];
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
        need = fmaxf(need, tcap[k]);
      }
    }
    need = block_max(need, red);

    // ---- front-to-back chunk walk ------------------------------------------
    for (int c = 0; c < nchunks; ++c) {
      if (!(tzmin[c] < need)) break;  // uniform across the block
      if (pix < CH) {
        const float* ch = tchunks + (size_t)c * 8 * CH;
        const float cx = ch[pix], cy = ch[CH + pix], cz = ch[2 * CH + pix];
        const float r = ch[3 * CH + pix];
        if (PERSP) {
          const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
          const float ccb = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
          // a dead slot gets ccb = +inf, so its discriminant is negative
          cand[pix] = make_float4(ocx, ocy, ocz, r > 0.0f ? ccb : INFINITY);
        } else {
          cand[pix] = make_float4(cx, cy, cz, r > 0.0f ? r * r : -INFINITY);
        }
      }
      __syncthreads();
      for (int j = 0; j < CH; ++j) {
        const float4 q = cand[j];
#pragma unroll
        for (int k = 0; k < SG; ++k) {
          if (k < ns) {
            float b, ccb;
            if (PERSP) {
              b = q.x * rdx[k] + q.y * rdy[k] + q.z * rdz[k];
              ccb = q.w;
            } else {
              const float ocx = rox[k] - q.x, ocy = roy[k] - q.y, ocz = roz[k] - q.z;
              b = ocx * rdx[k] + ocy * rdy[k] + ocz * rdz[k];
              ccb = ocx * ocx + ocy * ocy + ocz * ocz - q.w;
            }
            const float disc = b * b - ccb;
            if (disc >= 0.0f) {
              const float sq = sqrtf(disc);
              const float t1 = -b - sq;
              const float t2 = sq - b;
              const float t = t1 > eps ? t1 : (t2 > eps ? t2 : BIG);
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
      for (int k = 0; k < SG; ++k)
        if (k < ns) ln = fmaxf(ln, fminf(bt[k], tcap[k]));
      need = block_max(ln, red);  // its barriers also retire this chunk's reads
    }

    // ---- shading + shadow, per sample --------------------------------------
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      if (k < ns) {
        float cx = 0.f, cy = 0.f, cz = 0.f, rw = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
        if (bidx[k] >= 0) {
          const float* rp = tchunks + (size_t)(bidx[k] / CH) * 8 * CH + (bidx[k] % CH);
          cx = rp[0];
          cy = rp[CH];
          cz = rp[2 * CH];
          rw = rp[3 * CH];
          cr = rp[4 * CH];
          cg = rp[5 * CH];
          cb = rp[6 * CH];
        }
        const bool missed = (bt[k] >= BIG_DEPTH) || (rw <= 0.0f);
        const float tsafe = missed ? 0.0f : bt[k];
        const float hx = rox[k] + tsafe * rdx[k];
        const float hy = roy[k] + tsafe * rdy[k];
        const float hz = roz[k] + tsafe * rdz[k];
        float nx = hx - cx, ny = hy - cy, nz = hz - cz;
        const float inv = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
        nx *= inv;
        ny *= inv;
        nz *= inv;
        const float facing = nx * rdx[k] + ny * rdy[k] + nz * rdz[k];
        const float flip = facing > 0.0f ? -1.0f : 1.0f;
        nx *= flip;
        ny *= flip;
        nz *= flip;
        if (AO && SHADOWS && k == 0 && g == 0) {
          // sample 0: the shared occlusion of every sky light
          for (int l = 1; l < nlights; ++l) {
            const float* lp = slp + 16 * l;
            const float il = nx * lp[0] + ny * lp[1] + nz * lp[2];
            if (il > MINCONTRIB && !missed &&
                light_blocked(lp, hx, hy, hz, grid_n, l * grid_n * grid_n,
                              eps, lrec, loffs, lcnt, lkmax))
              aoblocked |= 1ull << l;
          }
        }
        const float inten = nx * lx + ny * ly + nz * lz;
        const bool litb = (inten > MINCONTRIB) && !missed;
        float filt = 1.0f;
        if (SHADOWS && litb &&
            light_blocked(sp + 15, hx, hy, hz, grid_n, 0, eps, lrec, loffs,
                          lcnt, lkmax))
          filt = 0.0f;
        const float lit = litb ? 1.0f : 0.0f;
        float sh = lit * inten * lightcol * filt;
        if (AO) {
          for (int l = 1; l < nlights; ++l) {
            const float* lp = slp + 16 * l;
            const float il = nx * lp[0] + ny * lp[1] + nz * lp[2];
            const float ll = (il > MINCONTRIB && !missed) ? 1.0f : 0.0f;
            const float fl = ((aoblocked >> l) & 1ull) ? 0.0f : 1.0f;
            sh = sh + ll * il * lp[12] * fl;
          }
        }
        const float shade = 0.8f * sh + ambient;
        ar = ar + (missed ? bgr : cr * shade);
        ag = ag + (missed ? bgg : cg * shade);
        ab = ab + (missed ? bgb : cb * shade);
      }
    }
  }
  tout[pix] = ar * inv_s;
  tout[P + pix] = ag * inv_s;
  tout[2 * P + pix] = ab * inv_s;
}

template <bool PERSP, bool SHADOWS, bool AO>
void launch(cudaStream_t st, int ntiles, int tile0, const float* params,
            const float* lparams, const float* chunks, const float* zmin,
            const float* lrec, const int* loffs, const int* lcnt,
            const float* lkmax, float* out, int nchunks, int tiles_x, int S,
            uint32_t seed, int grid_n, int nlights, float eps, float inv_s) {
  mega_render_kernel<PERSP, SHADOWS, AO><<<ntiles, P, 0, st>>>(
      params, lparams, chunks, zmin, reinterpret_cast<const float4*>(lrec),
      loffs, lcnt, lkmax, out, tile0, nchunks, tiles_x, S, seed, grid_n,
      nlights, eps, inv_s);
}

template <bool PERSP>
decltype(&launch<true, true, true>) pick(bool shadows, bool ao) {
  if (shadows) return ao ? &launch<PERSP, true, true> : &launch<PERSP, true, false>;
  return ao ? &launch<PERSP, false, true> : &launch<PERSP, false, false>;
}

}  // namespace

// Launches the kernel on `stream` over tiles [tile0, tile0 + ntiles) and
// writes their rows to out[0 .. ntiles); returns cudaGetLastError(), or
// cudaErrorInvalidValue when nlights is outside [1, MAX_LIGHTS].
// lparams holds nlights rows of 16 floats (row 0 is read from params);
// lrec must be 16-byte aligned (M, 8) rows [cu, cv, ck, r, key, alpha, 0, 0];
// loffs, lcnt and lkmax hold nlights x grid_n^2 cells, light after light.
extern "C" int mega_render_launch(const float* params, const float* lparams,
                                  const float* chunks, const float* zmin,
                                  const float* lrec, const int* loffs,
                                  const int* lcnt, const float* lkmax,
                                  float* out, int ntiles, int tile0,
                                  int nchunks, int tiles_x, int S,
                                  unsigned int seed, int grid_n, int nlights,
                                  float eps, float inv_s, int perspective,
                                  int shadows, void* stream) {
  if (nlights < 1 || nlights > MAX_LIGHTS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ao = nlights > 1;
  auto go = perspective ? pick<true>(shadows != 0, ao)
                        : pick<false>(shadows != 0, ao);
  go(st, ntiles, tile0, params, lparams, chunks, zmin, lrec, loffs, lcnt,
     lkmax, out, nchunks, tiles_x, S, seed, grid_n, nlights, eps, inv_s);
  return static_cast<int>(cudaGetLastError());
}
