// Hand CUDA kernel of the renderer's image out for Hopper (sm_90a): the
// frame's float32 RGB, (H, W, 3), to the final (H, W, 4) uint8 RGBA image in
// one pass.  Every route renders in float32 on the card; the float64 frames
// of the CPU backend take the plain version (render/image_out.py).
//
// It replaces no TPU kernel.  The JAX renderer quantizes with XLA ops and
// packs the RGBA array in host numpy (mdapy_tpu/render/render.py); the port
// did the same until the host pack, a fresh 36 MB array, a 3-byte strided
// store and an alpha pass on one thread, took 80-90 ms of a 3000x3000 frame
// while the card idled.  Here the card writes the image whole and the host
// only copies it.
//
// Per pixel, as render/config.py:quantize and the host pack computed it:
// - RGB: trunc((double)x * 255.0) clamped to [0, 255].  The product is
//   taken in double, as quantize takes it: for a float32 x it is exact,
//   so no rounding of the product can move the truncation.
// - alpha: the caller's byte (the background's alpha, rounded on the host),
//   or with `transparent` 0 where max_c |float(q_c) - bg_c| < 1.5 (float
//   arithmetic, bg_c the background * 255 in float) and 255 elsewhere.
//
// What bounds it on the card: bytes.  A frame moves 12 bytes in and 4 out
// a pixel, 108 MB and 36 MB at 3000x3000: 0.043 ms at 3.35 TB/s.
// What the design does about it:
// - A thread takes 4 pixels a step of a grid-stride loop: three 16-byte
//   loads of the 12 floats and one 16-byte store of the 4 RGBA words, so
//   every access is a full, coalesced 16-byte one.
// - The grid is a few blocks an SM, enough to keep the loads in flight.
// - A base that is not 16-byte aligned (a view into a larger frame) and the
//   last n_px % 4 pixels take a scalar loop, a word a pixel.
//
// Built by mdapy_tpu_torch/render/_build.py with nvcc for sm_90a into a
// shared library with a plain C interface (ctypes).

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_SM = 8;

struct Alpha {
  unsigned byte;      // the opaque alpha byte
  int transparent;    // 1: alpha from the distance to the background
  float bg0, bg1, bg2;
};

__device__ __forceinline__ unsigned quantize(float x) {
  double q = trunc(static_cast<double>(x) * 255.0);
  q = fmin(fmax(q, 0.0), 255.0);
  return static_cast<unsigned>(q);
}

// The pixel's RGBA bytes as one little-endian word.
__device__ __forceinline__ uint32_t rgba(float r, float g, float b,
                                         const Alpha& a) {
  const unsigned qr = quantize(r), qg = quantize(g), qb = quantize(b);
  unsigned alpha = a.byte;
  if (a.transparent) {
    const float d = fmaxf(fmaxf(fabsf(static_cast<float>(qr) - a.bg0),
                                fabsf(static_cast<float>(qg) - a.bg1)),
                          fabsf(static_cast<float>(qb) - a.bg2));
    alpha = d < 1.5f ? 0u : 255u;
  }
  return qr | (qg << 8) | (qb << 16) | (alpha << 24);
}

__global__ void __launch_bounds__(THREADS)
image_out_rgba_kernel(const float* __restrict__ in, uint32_t* __restrict__ out,
                      long long n_px, int aligned, Alpha a) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x
                          + threadIdx.x;
  const long long groups = aligned ? n_px / 4 : 0;
  const float4* vin = reinterpret_cast<const float4*>(in);
  uint4* vout = reinterpret_cast<uint4*>(out);
  for (long long g = first; g < groups; g += stride) {
    const float4 p = vin[3 * g], q = vin[3 * g + 1], r = vin[3 * g + 2];
    vout[g] = make_uint4(rgba(p.x, p.y, p.z, a), rgba(p.w, q.x, q.y, a),
                         rgba(q.z, q.w, r.x, a), rgba(r.y, r.z, r.w, a));
  }
  for (long long p = groups * 4 + first; p < n_px; p += stride)
    out[p] = rgba(in[3 * p], in[3 * p + 1], in[3 * p + 2], a);
}

}  // namespace

// Launches the RGBA pass on `stream` over n_px pixels of a contiguous
// float32 RGB frame `in` into `out` (n_px * 4 bytes, 16-byte aligned) and
// returns the first CUDA error.
extern "C" int image_out_rgba_launch(const float* in, uint8_t* out,
                                     long long n_px, int alpha_byte,
                                     int transparent, float bg0, float bg1,
                                     float bg2, void* stream) {
  if (n_px < 0 || alpha_byte < 0 || alpha_byte > 255
      || reinterpret_cast<uintptr_t>(out) % 16 != 0
      || reinterpret_cast<uintptr_t>(in) % sizeof(float) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_px == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const long long work = aligned ? (n_px + 3) / 4 : n_px;
  const long long need = (work + THREADS - 1) / THREADS;
  const long long most = static_cast<long long>(sms) * BLOCKS_SM;
  const Alpha a{static_cast<unsigned>(alpha_byte), transparent != 0,
                bg0, bg1, bg2};
  image_out_rgba_kernel<<<static_cast<unsigned>(need < most ? need : most),
                          THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, reinterpret_cast<uint32_t*>(out), n_px, aligned, a);
  return static_cast<int>(cudaGetLastError());
}
