// K1: multiresolution hash encoding, forward.
//
// Replaces nerf_signature_tpu/ops/hashenc.py:_hash_encode_impl (the exact
// 8-corner path) with _make_gather_rows' forward gather.
//
// What bounds it on the H100: memory.  Per sample it reads 12 B of position
// and writes L*F*4 = 128 B of features; the 8 corner rows per level are
// random 4-byte reads from the table.  The bf16 table copy at the default
// config is 16 levels * 2^19 rows * 4 B = 33.5 MB, which fits in the 50 MB
// L2, so after the first touches the gathers are L2 hits; the fp32 master
// table (67 MB) would not fit, which is why the caller gathers from a bf16
// copy cast once per render.
//
// Design: one thread per (sample, level), level-minor, so that a warp's
// feature stores land on consecutive 8-byte pairs (coalesced) and the
// position loads are broadcasts.  The corner hash is uint32 arithmetic that
// wraps exactly like the JAX version; dense levels use the row-major index.
// Each corner row (F = 2) is ONE 4-byte load (a bf16 pair) or one 8-byte
// load (fp32 pair).  The file is compiled with -fmad=false and every product
// and sum is written out in the JAX order (corner 0 first, weights as
// (wx|1-wx)*(wy|1-wy)*(wz|1-wz)), so the kernel rounds exactly where the
// plain version does.

#include <cuda_bf16.h>

#include "common.cuh"

#define NGP_MAX_LEVELS 32

struct HashLevels {
  int L;
  int log2_size;
  float res[NGP_MAX_LEVELS];
  unsigned int offset[NGP_MAX_LEVELS];
  unsigned int side[NGP_MAX_LEVELS];  // 0 = hashed level
};

__device__ __forceinline__ float2 load_row(const __nv_bfloat16* table, unsigned int row) {
  __nv_bfloat162 v = reinterpret_cast<const __nv_bfloat162*>(table)[row];
  return __bfloat1622float2(v);
}

__device__ __forceinline__ float2 load_row(const float* table, unsigned int row) {
  return reinterpret_cast<const float2*>(table)[row];
}

template <typename T>
__global__ void hash_encode_fwd(const float* __restrict__ x, const T* __restrict__ table,
                                float* __restrict__ out, long long M, HashLevels p) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= M * p.L) return;
  long long m = tid / p.L;
  int l = (int)(tid - m * p.L);

  const float res = p.res[l];
  float w[3];
  unsigned int cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float xa = ngp_clip(x[m * 3 + a], 0.0f, 1.0f);
    float s = __fmul_rn(xa, res);
    float f = floorf(s);
    w[a] = __fsub_rn(s, f);
    cell[a] = (unsigned int)f;
  }
  const unsigned int side = p.side[l];
  const unsigned int mask = (1u << p.log2_size) - 1u;
  const unsigned int off = p.offset[l];

  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned int di = (c >> 2) & 1u, dj = (c >> 1) & 1u, dk = c & 1u;
    const unsigned int cx = cell[0] + di, cy = cell[1] + dj, cz = cell[2] + dk;
    unsigned int idx;
    if (side) {
      idx = (cx * side + cy) * side + cz;
    } else {
      idx = ((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) & mask;
    }
    const float wx = di ? w[0] : __fsub_rn(1.0f, w[0]);
    const float wy = dj ? w[1] : __fsub_rn(1.0f, w[1]);
    const float wz = dk ? w[2] : __fsub_rn(1.0f, w[2]);
    const float cw = __fmul_rn(__fmul_rn(wx, wy), wz);
    const float2 r = load_row(table, idx + off);
    acc0 = __fadd_rn(acc0, __fmul_rn(cw, r.x));
    acc1 = __fadd_rn(acc1, __fmul_rn(cw, r.y));
  }
  reinterpret_cast<float2*>(out)[m * p.L + l] = make_float2(acc0, acc1);
}

extern "C" int ngp_hash_encode(const void* x, const void* table, int table_bf16, void* out,
                               long long M, int L, const float* res, const unsigned int* offset,
                               const unsigned int* side, int log2_size, void* stream) {
  if (L < 1 || L > NGP_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  HashLevels p;
  p.L = L;
  p.log2_size = log2_size;
  for (int l = 0; l < L; ++l) {
    p.res[l] = res[l];
    p.offset[l] = offset[l];
    p.side[l] = side[l];
  }
  if (M == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = ngp_blocks(M * L, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bf16) {
    hash_encode_fwd<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const float*)x, (const __nv_bfloat16*)table, (float*)out, M, p);
  } else {
    hash_encode_fwd<float><<<blocks, threads, 0, s>>>(
        (const float*)x, (const float*)table, (float*)out, M, p);
  }
  NGP_RETURN_LAST_ERROR();
}

extern "C" const char* ngp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
