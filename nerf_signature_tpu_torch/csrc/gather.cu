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
// / 3.35 TB/s = 1.9 us at the probe's shapes; there is no arithmetic.
//
// Design: one thread per index.  A 2 MB table cannot sit in the 227 KB of
// shared memory a block may use, so the TPU's "table in fast memory" design
// does not carry over; the table stays in the 50 MB L2 after the first
// touches, and the index loads and output stores are coalesced.  An index
// outside [0, T) is clamped to the nearest row (the plain version,
// table[idx], raises on it instead); callers pass indices in range.

#include "common.cuh"

__global__ void table_gather(const float* __restrict__ table, const int* __restrict__ idx,
                             long long T, long long N, float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  long long i = idx[j];
  i = i < 0 ? 0 : (i >= T ? T - 1 : i);
  out[j] = table[i];
}

// table [T] fp32, idx [N] int32, out [N] fp32.
extern "C" int ngp_table_gather(const void* table, const void* idx, long long T, long long N,
                                void* out, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int threads = 256;
  table_gather<<<ngp_blocks(N, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, T, N, (float*)out);
  NGP_RETURN_LAST_ERROR();
}
