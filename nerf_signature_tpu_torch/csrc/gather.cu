// P1: a scalar gather from a single-level table, out[j] = table[idx[j]].
//
// Replaces scripts_dev/pallas_gather_probe.py:pallas_gather, the repo's only
// Pallas kernel (a dev probe on no entry point's path): a [1, 2^19] fp32
// table held whole in VMEM, gathered at [1, 524288] int32 indices with
// take_along_axis.  Its idea, one gather from a single-level message table,
// lives on in K9 + K1 on the watermark path.
//
// What bounds it on the H100: bytes.  It must read the indices (4 B each)
// and the table (2 MB) once and write 4 B per output: (524,288 x 8 B + 2 MB)
// / 3.35 TB/s = 1.9 us at the probe's shapes; there is no arithmetic.  A 2
// MB table cannot sit in the 227 KB of shared memory a block may use, so the
// TPU's "table in fast memory" design does not carry over: the table stays
// in the 50 MB L2 after the first touches.
//
// Design: each thread takes 4 indices a step, one 16-byte load of indices
// and one 16-byte store of outputs, and reads the table through the
// read-only path (__ldg); a grid of as many 256-thread blocks as are
// resident on the SMs at once walks the vectors with a grid stride.  One
// launch covers any view: a scalar head (up to 3 indices, until idx is
// 16-byte aligned), the 4-wide body and a scalar tail (N - head not a
// multiple of 4); when out's alignment differs from idx's the body stores
// its 4 outputs one by one.  An index outside [0, T) is clamped to the
// nearest row (the plain version, table[idx], raises on it instead); callers
// pass indices in range.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float gather1(const float* __restrict__ table, int i, long long T) {
  const long long j = i < 0 ? 0 : (i >= T ? T - 1 : i);
  return __ldg(table + j);
}

__global__ void __launch_bounds__(THREADS)
    table_gather(const float* __restrict__ table, const int* __restrict__ idx, long long T,
                 long long N, float* __restrict__ out, long long head, int vec_out) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long n_vec = (N - head) / 4;
  const long long tail = head + 4 * n_vec;
  if (tid < head) out[tid] = gather1(table, idx[tid], T);
  if (tid < N - tail) out[tail + tid] = gather1(table, idx[tail + tid], T);
  const int4* iv = reinterpret_cast<const int4*>(idx + head);
  float* ob = out + head;
  for (long long v = tid; v < n_vec; v += stride) {
    const int4 i4 = iv[v];
    const float4 o = make_float4(gather1(table, i4.x, T), gather1(table, i4.y, T),
                                 gather1(table, i4.z, T), gather1(table, i4.w, T));
    if (vec_out) {
      reinterpret_cast<float4*>(ob)[v] = o;
    } else {
      ob[4 * v] = o.x;
      ob[4 * v + 1] = o.y;
      ob[4 * v + 2] = o.z;
      ob[4 * v + 3] = o.w;
    }
  }
}

// Blocks resident on the card at once (cached per device after the first call).
int resident_blocks(int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, table_gather, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = *blocks;
  return 0;
}

}  // namespace

// table [T] fp32, idx [N] int32, out [N] fp32; idx and out 4-byte aligned,
// any offset otherwise.
extern "C" int ngp_table_gather(const void* table, const void* idx, long long T, long long N,
                                void* out, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const uintptr_t ia = (uintptr_t)idx, oa = (uintptr_t)out;
  if (ia % 4 != 0 || oa % 4 != 0) return (int)cudaErrorInvalidValue;
  long long head = (long long)((16 - ia % 16) % 16 / 4);
  if (head > N) head = N;
  const int vec_out = (oa + 4 * head) % 16 == 0;
  const long long n_vec = (N - head) / 4;
  int most = 0;
  const int rc = resident_blocks(&most);
  if (rc != 0) return rc;
  const long long want = (n_vec + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 1 ? 1 : (want < most ? want : most));
  table_gather<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, T, N, (float*)out, head, vec_out);
  NGP_RETURN_LAST_ERROR();
}
