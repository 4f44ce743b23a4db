// K4: the NGP field heads, forward and backward, fused.
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

// ---------------------------------------------------------------- backward
//
// K4 backward (field_bwd + field_bwd_reduce): replaces JAX's autodiff of
// models/mlp.py:mlp_apply through _sigma_head and ngp_color, with
// trunc_exp's clamped VJP (ops/activation.py:24) and the sigmoid.  Given
// feat [M, IN], dirs [M, 3], the flat weights and the cotangents g_sigma [M]
// and g_rgb [M, 3], it returns g_feat [M, IN] and g_weights [N_W] (fp32).
// No gradient flows to dirs (SH has no parameters, rays carry none).
//
// bf16 rounding points (-O): JAX holds every activation AND every cotangent
// of mlp_apply in bf16 (jnp.dot(..., preferred_element_type=bf16)), so in
// bf16 mode this kernel rounds to bf16 at
//   (1) the cotangent entering each mlp_apply, i.e. the transpose of its
//       final .astype(float32): g_rgb * s(1-s) for the colour MLP, and
//       [g_sigma * exp(clip(h0, -15, 15)), g_geo] for the sigma MLP;
//   (2) each layer's input cotangent, g_in = round(g_out @ W^T) (fp32 sum,
//       one rounding), before the previous ReLU's mask;
//   (3) each weight gradient, ONCE, after the fp32 sum over all M samples
//       (in field_bwd_reduce): the bf16 dot's output, cast to fp32 by the
//       transpose of w.astype(bf16).
// The forward is recomputed with the forward kernel's exact roundings.
//
// What bounds it on the H100: at the training shapes the operations.  Per
// sample it does three passes over the 9,344 weights (the forward again,
// the input cotangents, the weight-gradient outer products), ~56 kFLOP, on
// the fp32 FMA units; the bytes it must move (feat and g_feat, dirs and the
// two cotangents, 284 B a sample at IN = 32) are fewer.
//
// Design: a persistent grid (one 128-thread block per SM; the wrapper
// passes the count) walks tiles of 128 samples, one sample per thread.
// Dynamic shared memory (189 KB at the default widths, set with
// cudaFuncSetAttribute) holds the bf16-rounded weights, the block's fp32
// weight-gradient partial sums, the tile's activations ([row][sample], so a
// thread's writes and a warp's reads are conflict-free) and one layer's
// output cotangents ([sample][j], padded).  A tile whose cotangents are
// all zero (the padded slots of rays that hit little) is skipped whole.
// Layer by layer: each thread
// writes its cotangent row, the block syncs, each thread owns a fixed set of
// weight entries and adds sum_t act[k][t] * cot[t][j] over the tile in a
// fixed order (no atomics), then each thread computes its own input
// cotangent.  The colour MLP is back-propagated first; the sigma MLP's
// forward is then recomputed into the same activation rows.  The block
// writes its partials to [n_blocks, N_W] and field_bwd_reduce sums them in
// block order: g_weights is deterministic for a given grid.

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

// One layer's backward inside the block.  act: this layer's input rows
// ([K][T]); g_out: this thread's (rounded) output cotangent; g_in: its input
// cotangent (rounded), zeroed where the input's ReLU was off when MASK.
template <int K, int J, bool MASK, int T, int LD>
__device__ __forceinline__ void layer_bwd(const float* __restrict__ W, float* __restrict__ dW,
                                          const float* __restrict__ act, float* __restrict__ cot,
                                          const float (&g_out)[J], float (&g_in)[K], bool bf16) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < J; ++j) cot[t * LD + j] = g_out[j];
  __syncthreads();
  for (int e = t; e < K * J; e += T) {
    const int k = e / J, j = e - k * J;
    const float* a = act + k * T;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 8
    for (int u = 0; u < T; u += 4) {
      s0 = fmaf(a[u + 0], cot[(u + 0) * LD + j], s0);
      s1 = fmaf(a[u + 1], cot[(u + 1) * LD + j], s1);
      s2 = fmaf(a[u + 2], cot[(u + 2) * LD + j], s2);
      s3 = fmaf(a[u + 3], cot[(u + 3) * LD + j], s3);
    }
    dW[e] += (s0 + s1) + (s2 + s3);
  }
  matvec_t<K, J>(W, g_out, g_in, bf16);
  if (MASK) {
#pragma unroll
    for (int k = 0; k < K; ++k) g_in[k] = act[k * T + t] > 0.0f ? g_in[k] : 0.0f;
  }
  __syncthreads();
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

template <int IN, int HID, int OUT1, int HC>
__global__ void __launch_bounds__(128, 1)
    field_bwd(const float* __restrict__ feat, const float* __restrict__ dirs,
              const float* __restrict__ weights, const float* __restrict__ g_sigma,
              const float* __restrict__ g_rgb, float* __restrict__ g_feat,
              float* __restrict__ partials, long long M, int bf16_mode) {
  using D = FieldDims<IN, HID, OUT1, HC>;
  constexpr int CIN = D::CIN, T = D::T, LD = D::LD, N_W = D::N_W;
  extern __shared__ float smem[];
  float* w_s = smem;
  float* dw_s = w_s + N_W;
  float* act = dw_s + N_W;
  float* cot = act + D::ACT_ROWS * T;
  const bool bf16 = bf16_mode != 0;
  for (int i = threadIdx.x; i < N_W; i += T) {
    w_s[i] = round_to(weights[i], bf16);
    dw_s[i] = 0.0f;
  }
  __syncthreads();
  const float* Ws0 = w_s;
  const float* Ws1 = Ws0 + D::N_S0;
  const float* Wc0 = Ws1 + D::N_S1;
  const float* Wc1 = Wc0 + D::N_C0;
  const float* Wc2 = Wc1 + D::N_C1;
  float* dWs0 = dw_s;
  float* dWs1 = dWs0 + D::N_S0;
  float* dWc0 = dWs1 + D::N_S1;
  float* dWc1 = dWc0 + D::N_C0;
  float* dWc2 = dWc1 + D::N_C1;
  const int t = threadIdx.x;

  for (long long base = (long long)blockIdx.x * T; base < M; base += (long long)gridDim.x * T) {
    const long long m = base + t;
    const bool valid = m < M;
    // a tile whose cotangents are all zero (padded or terminated samples)
    // adds nothing to g_weights and has a zero g_feat: skip its work
    const bool live = valid && (g_sigma[m] != 0.0f || g_rgb[m * 3 + 0] != 0.0f ||
                                g_rgb[m * 3 + 1] != 0.0f || g_rgb[m * 3 + 2] != 0.0f);
    if (!__syncthreads_or(live)) {
      if (valid) {
        float4* out = reinterpret_cast<float4*>(g_feat + m * IN);
#pragma unroll
        for (int k = 0; k < IN / 4; ++k) out[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      continue;
    }
    // ---- forward, recomputed; the colour MLP's inputs go to act rows
    float h0;
    float gc3[3];
    {
      float x[IN];
      load_feat<IN>(feat, m, valid, x, bf16);
      float h[HID];
      dense<IN, HID, true>(x, Ws0, h, bf16);
      float o[OUT1];
      dense<HID, OUT1, false>(h, Ws1, o, bf16);
      h0 = o[0];
      float c[CIN];
      if (valid) {
        sh4(dirs[m * 3 + 0], dirs[m * 3 + 1], dirs[m * 3 + 2], c);
      } else {
#pragma unroll
        for (int k = 0; k < SH_DIM; ++k) c[k] = 0.0f;
      }
#pragma unroll
      for (int j = 1; j < OUT1; ++j) c[SH_DIM + j - 1] = o[j];
#pragma unroll
      for (int k = 0; k < CIN; ++k) {
        c[k] = round_to(c[k], bf16);
        act[k * T + t] = c[k];
      }
      float c1[HC];
      dense<CIN, HC, true>(c, Wc0, c1, bf16);
#pragma unroll
      for (int k = 0; k < HC; ++k) act[(CIN + k) * T + t] = c1[k];
      float c2[HC];
      dense<HC, HC, true>(c1, Wc1, c2, bf16);
#pragma unroll
      for (int k = 0; k < HC; ++k) act[(CIN + HC + k) * T + t] = c2[k];
      float c3[3];
      dense<HC, 3, false>(c2, Wc2, c3, bf16);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float s = 1.0f / (1.0f + expf(-c3[j]));
        const float g = valid ? g_rgb[m * 3 + j] : 0.0f;
        gc3[j] = round_to(g * (s * (1.0f - s)), bf16);  // (1)
      }
    }
    // ---- colour MLP backward
    float g_in[CIN];
    {
      float g2[HC], g1[HC];
      layer_bwd<HC, 3, true, T, LD>(Wc2, dWc2, act + (CIN + HC) * T, cot, gc3, g2, bf16);
      layer_bwd<HC, HC, true, T, LD>(Wc1, dWc1, act + CIN * T, cot, g2, g1, bf16);
      layer_bwd<CIN, HC, false, T, LD>(Wc0, dWc0, act, cot, g1, g_in, bf16);
    }
    // ---- sigma MLP backward: trunc_exp's clamped VJP, then recompute the
    // sigma MLP's forward into the activation rows
    float gh[OUT1];
    gh[0] = round_to((valid ? g_sigma[m] : 0.0f) * expf(ngp_clip(h0, -15.0f, 15.0f)), bf16);
#pragma unroll
    for (int j = 1; j < OUT1; ++j) gh[j] = g_in[SH_DIM + j - 1];  // already bf16 values
    float gx[IN];
    {
      float x[IN];
      load_feat<IN>(feat, m, valid, x, bf16);
#pragma unroll
      for (int k = 0; k < IN; ++k) act[k * T + t] = x[k];
      float h[HID];
      dense<IN, HID, true>(x, Ws0, h, bf16);
#pragma unroll
      for (int k = 0; k < HID; ++k) act[(IN + k) * T + t] = h[k];
      float gh1[HID];
      layer_bwd<HID, OUT1, true, T, LD>(Ws1, dWs1, act + IN * T, cot, gh, gh1, bf16);
      layer_bwd<IN, HID, false, T, LD>(Ws0, dWs0, act, cot, gh1, gx, bf16);
    }
    if (valid) {
      float4* out = reinterpret_cast<float4*>(g_feat + m * IN);
#pragma unroll
      for (int k = 0; k < IN / 4; ++k)
        out[k] = make_float4(gx[4 * k], gx[4 * k + 1], gx[4 * k + 2], gx[4 * k + 3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N_W; i += T) partials[(long long)blockIdx.x * N_W + i] = dw_s[i];
}

// Sums the blocks' partials in block order; rounds once to bf16 in bf16 mode (3).
__global__ void field_bwd_reduce(const float* __restrict__ partials, int n_blocks, int n_w,
                                 float* __restrict__ g_weights, int bf16_mode) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_w) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long long)b * n_w + e];
  g_weights[e] = round_to(s, bf16_mode != 0);
}

template <int IN, int HID, int OUT1, int HC>
static int launch_field_bwd(const void* feat, const void* dirs, const void* weights,
                            const void* g_sigma, const void* g_rgb, void* g_feat, void* partials,
                            void* g_weights, long long M, int n_blocks, int bf16,
                            cudaStream_t s) {
  using D = FieldDims<IN, HID, OUT1, HC>;
  auto kernel = field_bwd<IN, HID, OUT1, HC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)D::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, D::T, D::SMEM, s>>>(
      (const float*)feat, (const float*)dirs, (const float*)weights, (const float*)g_sigma,
      (const float*)g_rgb, (float*)g_feat, (float*)partials, M, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  field_bwd_reduce<<<ngp_blocks(D::N_W, 256), 256, 0, s>>>((const float*)partials, n_blocks,
                                                           D::N_W, (float*)g_weights, bf16);
  NGP_RETURN_LAST_ERROR();
}

// partials: [n_blocks, N_W] fp32 scratch; n_blocks >= 1 blocks of 128 threads.
extern "C" int ngp_field_bwd(const void* feat, const void* dirs, const void* weights,
                             const void* g_sigma, const void* g_rgb, void* g_feat,
                             void* partials, void* g_weights, long long M, int n_blocks,
                             int in_dim, int hidden, int out1, int hidden_color, int bf16,
                             void* stream) {
  if (M == 0 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dim == 32 && hidden == 64 && out1 == 16 && hidden_color == 64)
    return launch_field_bwd<32, 64, 16, 64>(feat, dirs, weights, g_sigma, g_rgb, g_feat,
                                            partials, g_weights, M, n_blocks, bf16, s);
  if (in_dim == 8 && hidden == 16 && out1 == 16 && hidden_color == 16)
    return launch_field_bwd<8, 16, 16, 16>(feat, dirs, weights, g_sigma, g_rgb, g_feat,
                                           partials, g_weights, M, n_blocks, bf16, s);
  return (int)cudaErrorInvalidValue;
}
