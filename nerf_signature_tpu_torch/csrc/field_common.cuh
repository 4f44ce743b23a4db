// Device helpers shared by the K4 kernels (field.cu, field_feat.cu): the
// bf16 rounding, one dense layer, the degree-4 SH encoding, the transposed
// product of the backward, the layer widths and the feature load.  The
// sources that include it are compiled with -fmad=false.
#pragma once

#include <cuda_bf16.h>

#define SH_DIM 16

// The widths (IN, HID, OUT1, HC) every K4 source is built for, one X(...) a
// width: the NGPConfig defaults at 16 levels x 2 features and 8 x 4 (IN =
// 32), at 8 x 2 (IN = 16), at 16 x 4 and 32 x 2 (IN = 64), and the narrow
// test model (IN = 8).  The same
// list is ops/_cuda.py:FIELD_WIDTHS.  ptxas takes minutes on each width of
// the SIMT sources (field.cu, field_feat.cu), so ops/_cuda.py compiles them
// once a width (-DNGP_IN=.. -DNGP_HID=.. -DNGP_OUT1=.. -DNGP_HC=..: the
// object instantiates that width's launchers) and once without NGP_IN (the
// C entry points, which call the launchers of every width), all in parallel.
#define NGP_FIELD_WIDTHS(X) X(32, 64, 16, 64) X(16, 64, 16, 64) X(64, 64, 16, 64) X(8, 16, 16, 16)

__device__ __forceinline__ float round_to(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <int K, int J, bool RELU>
__device__ __forceinline__ void dense(const float (&in)[K], const float* __restrict__ W,
                                      float (&out)[J], bool bf16) {
#pragma unroll
  for (int j = 0; j < J; ++j) out[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float xk = in[k];
#pragma unroll
    for (int j = 0; j < J; ++j) out[j] = fmaf(xk, W[k * J + j], out[j]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float v = round_to(out[j], bf16);
    out[j] = RELU ? fmaxf(v, 0.0f) : v;
  }
}

// ops/sh.py:sh_encode at degree 4, term for term in the same order.
__device__ __forceinline__ void sh4(float x, float y, float z, float* o) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  o[0] = 0.28209479177387814f;
  o[1] = -0.4886025119029199f * y;
  o[2] = 0.4886025119029199f * z;
  o[3] = -0.4886025119029199f * x;
  o[4] = 1.0925484305920792f * xy;
  o[5] = -1.0925484305920792f * yz;
  o[6] = 0.31539156525252005f * (2.0f * zz - xx - yy);
  o[7] = -1.0925484305920792f * xz;
  o[8] = 0.5462742152960396f * (xx - yy);
  o[9] = -0.5900435899266435f * y * (3.0f * xx - yy);
  o[10] = 2.890611442640554f * xy * z;
  o[11] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
  o[12] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  o[13] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
  o[14] = 1.445305721320277f * z * (xx - yy);
  o[15] = -0.5900435899266435f * x * (xx - 3.0f * yy);
}

template <int K, int J>
__device__ __forceinline__ void matvec_t(const float* __restrict__ W, const float (&g)[J],
                                         float (&out)[K], bool bf16) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc = fmaf(W[k * J + j], g[j], acc);
    out[k] = round_to(acc, bf16);
  }
}

template <int IN, int HID, int OUT1, int HC>
struct FieldDims {
  static constexpr int CIN = SH_DIM + OUT1 - 1;
  static constexpr int N_S0 = IN * HID, N_S1 = HID * OUT1;
  static constexpr int N_C0 = CIN * HC, N_C1 = HC * HC, N_C2 = HC * 3;
  static constexpr int N_W = N_S0 + N_S1 + N_C0 + N_C1 + N_C2;
  static constexpr int T = 128;  // samples per tile = threads per block
  static constexpr int ACT_ROWS = (CIN + 2 * HC) > (IN + HID) ? (CIN + 2 * HC) : (IN + HID);
  static constexpr int LD = (HC > HID ? (HC > OUT1 ? HC : OUT1) : (HID > OUT1 ? HID : OUT1)) + 1;
  static constexpr size_t SMEM = sizeof(float) * (2 * N_W + ACT_ROWS * T + T * LD);
};

template <int IN>
__device__ __forceinline__ void load_feat(const float* __restrict__ feat, long long m, bool valid,
                                          float (&x)[IN], bool bf16) {
#pragma unroll
  for (int k = 0; k < IN / 4; ++k) {
    float4 v = valid ? reinterpret_cast<const float4*>(feat + m * IN)[k]
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[4 * k + 0] = round_to(v.x, bf16);
    x[4 * k + 1] = round_to(v.y, bf16);
    x[4 * k + 2] = round_to(v.z, bf16);
    x[4 * k + 3] = round_to(v.w, bf16);
  }
}
