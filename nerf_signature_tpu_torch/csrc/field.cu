// K4: the NGP field heads, forward, fused.
//
// Replaces nerf_signature_tpu/models/mlp.py:mlp_apply as called by
// models/ngp.py:_sigma_head and ngp_color, together with ops/sh.py:sh_encode
// (degree 4), ops/activation.py:trunc_exp (forward: exp) and the sigmoid.
// Per sample: h = relu(feat @ Ws0) ; o = h @ Ws1 ; sigma = exp(o[0]) ;
// geo = o[1:] ; c = [SH4(dir), geo] ; rgb = sigmoid(relu(relu(c @ Wc0) @ Wc1) @ Wc2).
//
// What bounds it on the H100: at the serving shapes (1,048,576 samples a
// chunk) the function must move 163 MB (features in, directions in, sigma
// and colour out), 0.05 ms at 3.35 TB/s, and its 19.6 GFLOP would take
// 0.02 ms on the bf16 tensor cores: the least time is the bytes.  This
// kernel runs the products on the fp32 FMA units (67 TFLOP/s, 0.29 ms for
// the same flops), so its own roof is operations; wgmma tiles are a later
// step.
//
// Design: the 9,344 weights of both MLPs (37 KB as fp32) are staged once per
// block in shared memory, rounded to bf16 first when the field computes in
// bf16, and every warp reads them as broadcasts.  One thread per sample
// keeps its activations in registers (the layer widths are template
// parameters, so the loops unroll).  A thread handles ONE sample: with a
// loop over samples the compiler hoists all 9,344 loop-invariant weight
// loads out of it and spills them (36 KB of stack a thread, measured with
// -Xptxas -v on sm_90a), so each 256-thread block stages the weights for
// its own 256 samples instead.  Rounding
// matches mlp_apply: in bf16 mode the input and EVERY layer's output are
// rounded to bf16 (jnp.dot(..., preferred_element_type=bf16)) before the
// ReLU, with fp32 accumulation inside a layer.  The file is compiled with
// -fmad=false, so the SH polynomials round like the plain version; the
// matrix products use explicit fmaf.

#include <cuda_bf16.h>

#include "common.cuh"

#define SH_DIM 16

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

// IN: encoding width; HID: sigma hidden; OUT1: 1 + geo width; HC: colour hidden.
template <int IN, int HID, int OUT1, int HC>
__global__ void field_fwd(const float* __restrict__ feat, const float* __restrict__ dirs,
                          const float* __restrict__ weights, float* __restrict__ sigma,
                          float* __restrict__ geo, float* __restrict__ rgb, long long M,
                          int bf16_mode) {
  constexpr int CIN = SH_DIM + OUT1 - 1;
  constexpr int N_S0 = IN * HID, N_S1 = HID * OUT1;
  constexpr int N_C0 = CIN * HC, N_C1 = HC * HC, N_C2 = HC * 3;
  constexpr int N_W = N_S0 + N_S1 + N_C0 + N_C1 + N_C2;
  __shared__ float w_s[N_W];
  const bool bf16 = bf16_mode != 0;
  for (int i = threadIdx.x; i < N_W; i += blockDim.x) w_s[i] = round_to(weights[i], bf16);
  __syncthreads();
  const float* Ws0 = w_s;
  const float* Ws1 = Ws0 + N_S0;
  const float* Wc0 = Ws1 + N_S1;
  const float* Wc1 = Wc0 + N_C0;
  const float* Wc2 = Wc1 + N_C1;

  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  {
    float x[IN];
    const float4* f4 = reinterpret_cast<const float4*>(feat + m * IN);
#pragma unroll
    for (int k = 0; k < IN / 4; ++k) {
      float4 v = f4[k];
      x[4 * k + 0] = round_to(v.x, bf16);
      x[4 * k + 1] = round_to(v.y, bf16);
      x[4 * k + 2] = round_to(v.z, bf16);
      x[4 * k + 3] = round_to(v.w, bf16);
    }
    float h[HID];
    dense<IN, HID, true>(x, Ws0, h, bf16);
    float o[OUT1];
    dense<HID, OUT1, false>(h, Ws1, o, bf16);
    sigma[m] = expf(o[0]);
    if (geo != nullptr) {
#pragma unroll
      for (int j = 1; j < OUT1; ++j) geo[m * (OUT1 - 1) + j - 1] = o[j];
    }
    if (rgb == nullptr) return;
    float c[CIN];
    sh4(dirs[m * 3 + 0], dirs[m * 3 + 1], dirs[m * 3 + 2], c);
#pragma unroll
    for (int j = 1; j < OUT1; ++j) c[SH_DIM + j - 1] = o[j];
#pragma unroll
    for (int k = 0; k < CIN; ++k) c[k] = round_to(c[k], bf16);
    float c1[HC];
    dense<CIN, HC, true>(c, Wc0, c1, bf16);
    float c2[HC];
    dense<HC, HC, true>(c1, Wc1, c2, bf16);
    float c3[3];
    dense<HC, 3, false>(c2, Wc2, c3, bf16);
#pragma unroll
    for (int j = 0; j < 3; ++j) rgb[m * 3 + j] = 1.0f / (1.0f + expf(-c3[j]));
  }
}

template <int IN, int HID, int OUT1, int HC>
static int launch_field(const void* feat, const void* dirs, const void* weights, void* sigma,
                        void* geo, void* rgb, long long M, int bf16, cudaStream_t s) {
  const int threads = 256;
  field_fwd<IN, HID, OUT1, HC><<<ngp_blocks(M, threads), threads, 0, s>>>(
      (const float*)feat, (const float*)dirs, (const float*)weights, (float*)sigma,
      (float*)geo, (float*)rgb, M, bf16);
  NGP_RETURN_LAST_ERROR();
}

// Widths supported: the NGPConfig defaults (32 -> 64 -> 16, 31 -> 64 -> 64 -> 3)
// and the narrow test config (8 -> 16 -> 16, 31 -> 16 -> 16 -> 3).
extern "C" int ngp_field(const void* feat, const void* dirs, const void* weights, void* sigma,
                         void* geo, void* rgb, long long M, int in_dim, int hidden, int out1,
                         int hidden_color, int bf16, void* stream) {
  if (M == 0) return 0;
  if (rgb != nullptr && dirs == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dim == 32 && hidden == 64 && out1 == 16 && hidden_color == 64)
    return launch_field<32, 64, 16, 64>(feat, dirs, weights, sigma, geo, rgb, M, bf16, s);
  if (in_dim == 8 && hidden == 16 && out1 == 16 && hidden_color == 16)
    return launch_field<8, 16, 16, 16>(feat, dirs, weights, sigma, geo, rgb, M, bf16, s);
  return (int)cudaErrorInvalidValue;
}
