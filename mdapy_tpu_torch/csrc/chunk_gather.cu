// Hand CUDA kernel of the per-tile sphere records for Hopper (sm_90a): the
// screen bins' (nb, nchunks, CH) int64 sphere ids to the (nb, nchunks, 8, CH)
// float32 records that the megakernel and the tiled tracer stage chunk by
// chunk, in one pass.  Every gather on the card takes it (the wrapper casts
// other types); the CPU takes the plain version (render/gather.py).
//
// It replaces no TPU kernel.  The JAX package gathers with XLA ops
// (mdapy_tpu/render/pallas_kernels.py:gather_chunk_data); the port did the
// same in PyTorch: a row gather of the packed (n, 8) table, a strided where
// for the padding, and a transpose copy.  PyTorch's row gather gives each
// index a block of its own, so the demo's frame (9.05 M slots, 289.5 MB of
// records) took 4-6 ms, about 50 GB/s of writes, and the transpose then read
// and wrote the records again.
//
// Per slot (b, c, k) with id = ids[b, c, k], for f = 0..7:
//   out[b, c, f, k] = table[max(id, 0), f],
// and a padded slot (id < 0) gets -1.0f in field 3 (r).  The fields are
// copied as they are, bit for bit.  The ids come from the screen bins and
// lie in [-1, n); an id at or past n stops the kernel with a trap, as the
// plain version's index fails on the device, so that a fault upstream is
// never turned into records that are silently wrong.
//
// What bounds it on the card: bytes.  A slot writes 32 bytes and reads its
// 8-byte id; the table (32 bytes a sphere, 1 MB at 32,000 spheres) stays in
// L2.  The demo's frame moves 289.5 MB out and 72.4 MB in: 0.108 ms at
// 3.35 TB/s.
// What the design does about it:
// - A thread takes 4 consecutive slots of one chunk a step of a grid-stride
//   loop (CH % 4 == 0, ids 16-byte aligned): their ids in two 16-byte loads,
//   then the 4 rows, two 16-byte read-only loads each, so 4 dependent row
//   loads are in flight a thread.  Each field then leaves in one 16-byte
//   streaming store, and a warp's 32 threads write 512 contiguous bytes of
//   it: the transpose costs nothing, and the records, larger than L2, do not
//   push the table out of it.
// - Otherwise a thread takes one slot a step and stores field by field, a
//   warp's 128 contiguous bytes a field.
// - The grid is as many blocks as fit on the card at once.
//
// Built by mdapy_tpu_torch/render/_build.py with nvcc for sm_90a into a
// shared library with a plain C interface (ctypes).

#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int V>
__device__ __forceinline__ void store_field(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcs(p, v[0]);
}

// V consecutive slots of one chunk a step; n_items = n_slots / V.
template <int V>
__global__ void __launch_bounds__(THREADS)
chunk_gather_kernel(const long long* __restrict__ ids,
                    const float4* __restrict__ table, long long n_rows,
                    float* __restrict__ out, long long n_items, int ch) {
  const int ch_v = ch / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n_items; i += stride) {
    const long long g = i / ch_v;                       // chunk (b, c)
    const int k = static_cast<int>(i - g * ch_v) * V;   // its first slot
    long long id[V];
    if constexpr (V == 4) {
      const auto* p = reinterpret_cast<const longlong2*>(ids + g * ch + k);
      const longlong2 a = __ldg(p), b = __ldg(p + 1);
      id[0] = a.x; id[1] = a.y; id[2] = b.x; id[3] = b.y;
    } else {
      id[0] = __ldg(ids + g * ch + k);
    }
    float4 lo[V], hi[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (id[j] >= n_rows) __trap();
      const long long r = id[j] < 0 ? 0 : id[j];
      lo[j] = __ldg(table + 2 * r);
      hi[j] = __ldg(table + 2 * r + 1);
    }
    float rec[8][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      rec[0][j] = lo[j].x; rec[1][j] = lo[j].y; rec[2][j] = lo[j].z;
      rec[3][j] = id[j] < 0 ? -1.0f : lo[j].w;
      rec[4][j] = hi[j].x; rec[5][j] = hi[j].y; rec[6][j] = hi[j].z;
      rec[7][j] = hi[j].w;
    }
    float* o = out + g * 8 * ch + k;
#pragma unroll
    for (int f = 0; f < 8; ++f) store_field<V>(o + f * ch, rec[f]);
  }
}

template <int V>
cudaError_t launch(const long long* ids, const float4* table, long long n_rows,
                   float* out, long long n_slots, int ch, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chunk_gather_kernel<V>, THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long n_items = n_slots / V;
  const long long need = (n_items + THREADS - 1) / THREADS;
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  chunk_gather_kernel<V><<<static_cast<unsigned>(need < most ? need : most),
                           THREADS, 0, stream>>>(ids, table, n_rows, out,
                                                 n_items, ch);
  return cudaGetLastError();
}

}  // namespace

// Launches the gather on `stream`: n_slots int64 ids (contiguous, 8-byte
// aligned; n_slots a multiple of ch) against a 16-byte aligned (n_rows, 8)
// float32 table into `out` (n_slots * 8 floats, 16-byte aligned), and
// returns the first CUDA error.
extern "C" int chunk_gather_launch(const long long* ids, const float* table,
                                   long long n_rows, float* out,
                                   long long n_slots, int ch, void* stream) {
  const uintptr_t pi = reinterpret_cast<uintptr_t>(ids);
  if (n_slots < 0 || ch < 1 || n_slots % ch != 0 || n_rows < 1
      || pi % sizeof(long long) != 0
      || reinterpret_cast<uintptr_t>(table) % 16 != 0
      || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) return 0;
  const auto* rows = reinterpret_cast<const float4*>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      ch % 4 == 0 && pi % 16 == 0
          ? launch<4>(ids, rows, n_rows, out, n_slots, ch, s)
          : launch<1>(ids, rows, n_rows, out, n_slots, ch, s);
  return static_cast<int>(err);
}
