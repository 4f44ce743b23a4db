// K4 backward without the weight gradient (field_bwd_feat): the watermark
// stage's frozen backbone.  Replaces JAX's autodiff of
// nerf_signature_tpu/models/mlp.py:mlp_apply (through _sigma_head, ngp_color,
// trunc_exp and the sigmoid) where the weights are a captured constant:
// nerf_signature_tpu/train/trainer_wtmk.py:_wm_step_loss differentiates the
// trainable subtree only, so the backbone's MLPs pass back the input
// cotangent alone, g_feat [M, IN] from g_sigma and g_rgb, with JAX's bf16
// rounding points (1) and (2) (field_mma.cuh) and no (3) when the flag
// asks for them.
//
// What bounds it on the H100: per sample the forward again and one
// transposed product a layer (4 flops a weight, 37 kFLOP) on the fp32 FMA
// units, against 284 B of inputs and outputs a sample: operations, at the
// kernel's own roof; the bytes are the least time.
//
// Design: one thread per sample, no tile, no outer products, no block
// partials and no reduce.  The weights are staged in static shared memory
// (37 KB at the default widths, so several blocks fit on an SM, where
// field_bwd's 189 KB allows one); the forward keeps only the ReLU masks of
// the hidden layers (one bit a unit) in registers, since the input
// cotangents need nothing else of the activations.  A sample whose
// cotangents are all zero writes a zero g_feat and does no work.  The
// products and roundings are field_bwd's (matvec_t), so g_feat equals its
// g_feat bit for bit.  The port calls it for the fp32 route only (bf16 runs
// on the tensor cores, field_mma_bwd.cu), but the rounding stays a runtime
// argument: with it known at compile time ptxas hoists the weight loads,
// and the full-width kernel spilled 34 KB (-Xptxas -v, sm_90a) and took 38
// ms at the watermark step's shapes on an H100.  A file of its own so that
// nvcc builds it in parallel with field.cu.

#include <cuda_bf16.h>

#include "common.cuh"
#include "field_common.cuh"

template <int J>
__device__ __forceinline__ unsigned long long relu_mask(const float (&a)[J]) {
  unsigned long long m = 0ull;
#pragma unroll
  for (int j = 0; j < J; ++j) m |= (a[j] > 0.0f ? 1ull : 0ull) << j;
  return m;
}

template <int K>
__device__ __forceinline__ void apply_mask(float (&g)[K], unsigned long long m) {
#pragma unroll
  for (int k = 0; k < K; ++k) g[k] = ((m >> k) & 1ull) ? g[k] : 0.0f;
}

template <int IN, int HID, int OUT1, int HC>
__global__ void __launch_bounds__(128)
    field_bwd_feat(const float* __restrict__ feat, const float* __restrict__ dirs,
                   const float* __restrict__ weights, const float* __restrict__ g_sigma,
                   const float* __restrict__ g_rgb, float* __restrict__ g_feat, long long M,
                   int bf16_mode) {
  using D = FieldDims<IN, HID, OUT1, HC>;
  static_assert(HID <= 64 && HC <= 64, "ReLU masks are 64-bit");
  constexpr int CIN = D::CIN, N_W = D::N_W;
  __shared__ float w_s[N_W];
  const bool bf16 = bf16_mode != 0;
  for (int i = threadIdx.x; i < N_W; i += blockDim.x) w_s[i] = round_to(weights[i], bf16);
  __syncthreads();
  const float* Ws0 = w_s;
  const float* Ws1 = Ws0 + D::N_S0;
  const float* Wc0 = Ws1 + D::N_S1;
  const float* Wc1 = Wc0 + D::N_C0;
  const float* Wc2 = Wc1 + D::N_C1;

  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float4* out = reinterpret_cast<float4*>(g_feat + m * IN);
  const float gs = g_sigma[m];
  const float gr0 = g_rgb[m * 3 + 0], gr1 = g_rgb[m * 3 + 1], gr2 = g_rgb[m * 3 + 2];
  if (gs == 0.0f && gr0 == 0.0f && gr1 == 0.0f && gr2 == 0.0f) {
#pragma unroll
    for (int k = 0; k < IN / 4; ++k) out[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  // ---- forward, recomputed with the forward kernel's roundings; keep masks
  unsigned long long mask_h, mask_c1, mask_c2;
  float h0;
  float gc3[3];
  {
    float x[IN];
    load_feat<IN>(feat, m, true, x, bf16);
    float h[HID];
    dense<IN, HID, true>(x, Ws0, h, bf16);
    mask_h = relu_mask<HID>(h);
    float o[OUT1];
    dense<HID, OUT1, false>(h, Ws1, o, bf16);
    h0 = o[0];
    float c[CIN];
    sh4(dirs[m * 3 + 0], dirs[m * 3 + 1], dirs[m * 3 + 2], c);
#pragma unroll
    for (int j = 1; j < OUT1; ++j) c[SH_DIM + j - 1] = o[j];
#pragma unroll
    for (int k = 0; k < CIN; ++k) c[k] = round_to(c[k], bf16);
    float c1[HC];
    dense<CIN, HC, true>(c, Wc0, c1, bf16);
    mask_c1 = relu_mask<HC>(c1);
    float c2[HC];
    dense<HC, HC, true>(c1, Wc1, c2, bf16);
    mask_c2 = relu_mask<HC>(c2);
    float c3[3];
    dense<HC, 3, false>(c2, Wc2, c3, bf16);
    const float gr[3] = {gr0, gr1, gr2};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float s = 1.0f / (1.0f + expf(-c3[j]));
      gc3[j] = round_to(gr[j] * (s * (1.0f - s)), bf16);  // (1)
    }
  }
  // ---- colour MLP, input cotangents only (2)
  float g_in[CIN];
  {
    float g2[HC], g1[HC];
    matvec_t<HC, 3>(Wc2, gc3, g2, bf16);
    apply_mask<HC>(g2, mask_c2);
    matvec_t<HC, HC>(Wc1, g2, g1, bf16);
    apply_mask<HC>(g1, mask_c1);
    matvec_t<CIN, HC>(Wc0, g1, g_in, bf16);
  }
  // ---- sigma MLP: trunc_exp's clamped VJP, then the two layers
  float gh[OUT1];
  gh[0] = round_to(gs * expf(ngp_clip(h0, -15.0f, 15.0f)), bf16);
#pragma unroll
  for (int j = 1; j < OUT1; ++j) gh[j] = g_in[SH_DIM + j - 1];
  float gh1[HID];
  matvec_t<HID, OUT1>(Ws1, gh, gh1, bf16);
  apply_mask<HID>(gh1, mask_h);
  float gx[IN];
  matvec_t<IN, HID>(Ws0, gh1, gx, bf16);
#pragma unroll
  for (int k = 0; k < IN / 4; ++k)
    out[k] = make_float4(gx[4 * k], gx[4 * k + 1], gx[4 * k + 2], gx[4 * k + 3]);
}

template <int IN, int HID, int OUT1, int HC>
int launch_field_bwd_feat(const void* feat, const void* dirs, const void* weights,
                          const void* g_sigma, const void* g_rgb, void* g_feat, long long M,
                          int bf16, cudaStream_t s) {
  const int threads = 128;
  field_bwd_feat<IN, HID, OUT1, HC><<<ngp_blocks(M, threads), threads, 0, s>>>(
      (const float*)feat, (const float*)dirs, (const float*)weights, (const float*)g_sigma,
      (const float*)g_rgb, (float*)g_feat, M, bf16);
  NGP_RETURN_LAST_ERROR();
}

#ifndef NGP_IN
#define NGP_EXTERN(IN, HID, OUT1, HC) \
  extern template int launch_field_bwd_feat<IN, HID, OUT1, HC>(                           \
      const void*, const void*, const void*, const void*, const void*, void*, long long, int, \
      cudaStream_t);
NGP_FIELD_WIDTHS(NGP_EXTERN)
#undef NGP_EXTERN

extern "C" int ngp_field_bwd_feat(const void* feat, const void* dirs, const void* weights,
                                  const void* g_sigma, const void* g_rgb, void* g_feat,
                                  long long M, int in_dim, int hidden, int out1,
                                  int hidden_color, int bf16, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return launch_field_bwd_feat<IN, HID, OUT1, HC>(feat, dirs, weights, g_sigma, g_rgb,      \
                                                    g_feat, M, bf16, s);
  NGP_FIELD_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}
#else
template int launch_field_bwd_feat<NGP_IN, NGP_HID, NGP_OUT1, NGP_HC>(
    const void*, const void*, const void*, const void*, const void*, void*, long long, int,
    cudaStream_t);
#endif  // NGP_IN
