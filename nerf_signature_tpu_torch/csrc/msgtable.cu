// K9: the codebook's effective table, forward and backward.
//
// Replaces nerf_signature_tpu/models/message.py:msg_effective_table (the
// take_along_axis that picks tables[i, m_i] for every bit i, the sum over
// the bits) and the cast to the gather dtype that
// models/watermark.py:_msg_feature's hash_encode does before its gather.
//
// Forward (ngp_msg_table): eff[e] = sum_i tables[i, m_i, e] over the D bits
// in order i = 0..D-1 (fp32, one rounding per add, like the plain loop), and
// in the same pass eff_g[e] = eff[e] in the gather dtype (bf16 by
// round-to-nearest-even, or fp32), which K1 then reads.  e runs over the
// T * F entries of one table.
//
// Backward (ngp_msg_table_bwd): the transpose of the selection and the sum:
// g_tables[i, m_i] = g_eff and g_tables[i, 1 - m_i] = 0 for every bit.  The
// zeros are written, not skipped: Adam moves the unselected tables through
// their moments exactly as JAX's dense gradient does.
//
// What bounds it on the H100: bytes.  At D = 32, T = 2^19, F = 2 the forward
// reads 32 selected tables of 4 MB and writes 4 MB + 2 MB (0.042 ms at
// 3.35 TB/s); it does one add per read element.  The backward writes the
// whole 268 MB gradient (0.08 ms) and reads g_eff (4 MB).
//
// Forward design: one thread per table entry e, so a warp's loads and
// stores are 128 consecutive bytes for every bit; the message (D int32) is
// staged in shared memory.  Backward design: one thread per 4 consecutive
// entries of g_eff (one 16-byte load, held in registers), which it writes,
// or zeros, into all 2D tables as 16-byte streaming stores (a warp's store
// covers 512 contiguous bytes of one table); the message is staged as a bit
// mask in shared memory, 32 bits a word.  So g_eff is read once, not 2D
// times, and each thread's 2D stores are independent.  Where T * F is not
// a multiple of 4 (or a pointer is not 16-byte aligned) the same loop runs
// one entry a thread.  A message bit that is not 0 counts as 1.  The file
// is compiled with -fmad=false (there is no product to contract; the flag
// keeps the build rules of the other sources).

#include <cuda_bf16.h>

#include "common.cuh"

#define NGP_MSG_MAX_BITS 1024

__global__ void msg_table_fwd(const float* __restrict__ tables, const int* __restrict__ message,
                              int D, long long TF, float* __restrict__ eff,
                              void* __restrict__ eff_g, int bf16) {
  __shared__ int sel[NGP_MSG_MAX_BITS];
  for (int i = threadIdx.x; i < D; i += blockDim.x) sel[i] = message[i] != 0;
  __syncthreads();
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= TF) return;
  float acc = tables[(long long)sel[0] * TF + e];
  for (int i = 1; i < D; ++i) acc = __fadd_rn(acc, tables[((long long)2 * i + sel[i]) * TF + e]);
  eff[e] = acc;
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(eff_g)[e] = __float2bfloat16_rn(acc);
  } else {
    reinterpret_cast<float*>(eff_g)[e] = acc;
  }
}

#define NGP_MSG_BWD_MAX_BITS 32768

// V floats of g_eff a thread (V = 4: one float4), n = TF / V of them
template <typename Vec>
__global__ void msg_table_bwd(const Vec* __restrict__ g_eff, const int* __restrict__ message,
                              int D, long long n, Vec* __restrict__ g_tables) {
  __shared__ unsigned int sel[NGP_MSG_BWD_MAX_BITS / 32];
  const int words = (D + 31) >> 5;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned int bits = 0u;
    for (int b = 0; b < 32 && 32 * w + b < D; ++b)
      bits |= (unsigned int)(message[32 * w + b] != 0) << b;
    sel[w] = bits;
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Vec v = __ldg(g_eff + i), z{};
  for (int w = 0; w < words; ++w) {
    const unsigned int bits = sel[w];
    const int nb = min(32, D - 32 * w);
    for (int b = 0; b < nb; ++b) {
      const long long bit = 32 * w + b;
      const int m = (bits >> b) & 1u;
      __stcs(g_tables + (2 * bit + m) * n + i, v);
      __stcs(g_tables + (2 * bit + 1 - m) * n + i, z);
    }
  }
}

// tables [D, 2, T, F] fp32; message [D] int32 on the device; eff [T, F] fp32;
// eff_g [T, F] bf16 (bf16 = 1) or fp32 (bf16 = 0).  TF = T * F.
extern "C" int ngp_msg_table(const void* tables, const void* message, int D, long long TF,
                             void* eff, void* eff_g, int bf16, void* stream) {
  if (D < 1 || D > NGP_MSG_MAX_BITS || TF < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  msg_table_fwd<<<ngp_blocks(TF, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)tables, (const int*)message, D, TF, (float*)eff, eff_g, bf16);
  NGP_RETURN_LAST_ERROR();
}

// g_eff [T, F] fp32; message [D] int32; g_tables [D, 2, T, F] fp32 (every
// entry written).
extern "C" int ngp_msg_table_bwd(const void* g_eff, const void* message, int D, long long TF,
                                 void* g_tables, void* stream) {
  if (D < 1 || D > NGP_MSG_BWD_MAX_BITS - 1 || TF < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (TF % 4 == 0 && (unsigned long long)g_eff % 16 == 0 &&
      (unsigned long long)g_tables % 16 == 0) {
    msg_table_bwd<float4><<<ngp_blocks(TF / 4, threads), threads, 0, s>>>(
        (const float4*)g_eff, (const int*)message, D, TF / 4, (float4*)g_tables);
  } else {
    msg_table_bwd<float><<<ngp_blocks(TF, threads), threads, 0, s>>>(
        (const float*)g_eff, (const int*)message, D, TF, (float*)g_tables);
  }
  NGP_RETURN_LAST_ERROR();
}
