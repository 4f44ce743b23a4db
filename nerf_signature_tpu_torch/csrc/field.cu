// K4: the NGP field heads, forward and backward, fused.
//
// Replaces nerf_signature_tpu/models/mlp.py:mlp_apply as called by
// models/ngp.py:_sigma_head and ngp_color, together with ops/sh.py:sh_encode
// (degree 4), ops/activation.py:trunc_exp (forward: exp) and the sigmoid.
// Per sample: h = relu(feat @ Ws0) ; o = h @ Ws1 ; sigma = exp(o[0]) ;
// geo = o[1:] ; c = [SH4(dir), geo] ; rgb = sigmoid(relu(relu(c @ Wc0) @ Wc1) @ Wc2).
// Where ``raw`` is given, the density logit o[0] itself is written too (the
// CopyRNeRF baseline's MLP reads it; log(sigma) would be -inf wherever
// exp underflows).
//
// What bounds it on the H100: at the serving shapes (1,048,576 samples a
// chunk) the function must move 163 MB (features in, directions in, sigma
// and colour out), 0.05 ms at 3.35 TB/s, and its 19.6 GFLOP would take
// 0.02 ms on the bf16 tensor cores: the least time is the bytes.  This
// kernel runs the products on the fp32 FMA units (67 TFLOP/s, 0.29 ms for
// the same flops), so its own roof is operations.  It is the fp32 route; in
// bf16 the forward runs on the tensor cores (field_mma.cu).
//
// Design: each layer is a small product over a tile of 128 samples
// (field_common.cuh:MicroTile), as an SGEMM does it.  A persistent grid (two
// 128-thread blocks an SM; the wrapper passes the count) stages the 9,344
// weights (37 KB as fp32; 45.6 KB at IN = 64) in shared memory once per
// block and walks tiles.  The tile's activations live in two shared buffers
// ([row][sample]) that the layers use in turn: feat -> P, h -> Q, o -> P
// rows 15..30 (o[0] read per sample for sigma, then SH4 written to rows
// 0..15: P is the colour MLP's input c), c1 -> Q, c2 -> P, and the 64 -> 3
// output one thread a sample.  A thread keeps an 8 x 8 (4 x 4 for 16-wide
// layers) register tile of sums and per input row loads 8 activations and 8
// weights with 16-byte shared loads for 64 FMAs; one thread a sample
// read the weights once an FMA, so shared memory's issue rate capped it.
// Every output still starts at 0.0f and adds fmaf over k ascending (dense's
// order), so sigma, geo and rgb are bit-equal to the one-thread-a-sample
// kernel's.  In fp32 mlp_apply rounds nowhere between layers, and neither
// does this kernel.  The file is compiled with -fmad=false, so the SH
// polynomials round like the plain version; the products use explicit fmaf.

#include <cuda_bf16.h>

#include "common.cuh"
#include "field_common.cuh"

#define NGP_FWD_T 128  // samples a tile = threads a block (models/ngp.py:SIMT_TILE)

// IN: encoding width; HID: sigma hidden; OUT1: 1 + geo width; HC: colour hidden.
template <int IN, int HID, int OUT1, int HC>
__global__ void __launch_bounds__(NGP_FWD_T, 2)
    field_fwd(const float* __restrict__ feat, const float* __restrict__ dirs,
              const float* __restrict__ weights, float* __restrict__ sigma,
              float* __restrict__ geo, float* __restrict__ rgb, float* __restrict__ raw,
              long long M) {
  constexpr int T = NGP_FWD_T;
  using D = SimtDims<IN, HID, OUT1, HC, T, false>;
  using F = FieldDims<IN, HID, OUT1, HC>;
  constexpr int CIN = D::CIN;
  extern __shared__ __align__(16) float smem[];
  float* P = smem;
  float* Q = P + D::ROWS * T;
  float* w_s = Q + D::ROWS * T;
  for (int i = threadIdx.x; i < D::N_W; i += T) w_s[i] = weights[i];
  const float* Ws0 = w_s;
  const float* Ws1 = Ws0 + F::N_S0;
  const float* Wc0 = Ws1 + F::N_S1;
  const float* Wc1 = Wc0 + F::N_C0;
  const float* Wc2 = Wc1 + F::N_C1;
  const int t = threadIdx.x;

  for (long long base = (long long)blockIdx.x * T; base < M; base += (long long)gridDim.x * T) {
    const long long m = base + t;
    const bool valid = m < M;
    __syncthreads();  // the weights staged; the last tile's reads of P and Q done
    tile_feat<IN, T>(feat, m, valid, P);
    tile_sigma_mlp<IN, HID, OUT1, T>(P, Q, Ws0, Ws1);
    // per sample: sigma, the logit, geo
    const float o0 = P[(SH_DIM - 1) * T + t];
    if (valid) {
      sigma[m] = expf(o0);
      if (raw != nullptr) raw[m] = o0;
      if (geo != nullptr) {
#pragma unroll
        for (int j = 1; j < OUT1; ++j) geo[m * (OUT1 - 1) + j - 1] = P[(SH_DIM - 1 + j) * T + t];
      }
    }
    if (rgb == nullptr) continue;  // the density-only query (the same for the whole grid)
    tile_sh4<T>(dirs, m, valid, P);
    tile_colour_mlp<CIN, HC, T>(P, Q, Wc0, Wc1);
    float c3[3];
    colour_logits<HC, T>(P, Wc2, c3);
    if (valid) {
#pragma unroll
      for (int j = 0; j < 3; ++j) rgb[m * 3 + j] = 1.0f / (1.0f + expf(-c3[j]));
    }
  }
}

template <int IN, int HID, int OUT1, int HC>
int launch_field(const void* feat, const void* dirs, const void* weights, void* sigma,
                 void* geo, void* rgb, void* raw, long long M, int n_blocks, long long smem,
                 cudaStream_t s) {
  using D = SimtDims<IN, HID, OUT1, HC, NGP_FWD_T, false>;
  if (smem != (long long)D::SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = field_fwd<IN, HID, OUT1, HC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)D::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, NGP_FWD_T, D::SMEM, s>>>(
      (const float*)feat, (const float*)dirs, (const float*)weights, (float*)sigma,
      (float*)geo, (float*)rgb, (float*)raw, M);
  NGP_RETURN_LAST_ERROR();
}

#ifndef NGP_IN
#define NGP_EXTERN(IN, HID, OUT1, HC) \
  extern template int launch_field<IN, HID, OUT1, HC>(const void*, const void*, const void*, \
                                                      void*, void*, void*, void*, long long,   \
                                                      int, long long, cudaStream_t);
NGP_FIELD_WIDTHS(NGP_EXTERN)
#undef NGP_EXTERN

// Widths supported: NGP_FIELD_WIDTHS (field_common.cuh).  fp32 only.
// raw: the density logit [M] fp32, or NULL.  n_blocks >= 1 blocks of 128
// threads with smem bytes of dynamic shared memory each (models/ngp.py:
// simt_launch; any other size is refused).
extern "C" int ngp_field_raw(const void* feat, const void* dirs, const void* weights,
                             void* sigma, void* geo, void* rgb, void* raw, long long M,
                             int in_dim, int hidden, int out1, int hidden_color, int n_blocks,
                             long long smem, void* stream) {
  if (M == 0) return 0;
  if ((rgb != nullptr && dirs == nullptr) || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return launch_field<IN, HID, OUT1, HC>(feat, dirs, weights, sigma, geo, rgb, raw, M,      \
                                           n_blocks, smem, s);
  NGP_FIELD_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int ngp_field(const void* feat, const void* dirs, const void* weights, void* sigma,
                         void* geo, void* rgb, long long M, int in_dim, int hidden, int out1,
                         int hidden_color, int n_blocks, long long smem, void* stream) {
  return ngp_field_raw(feat, dirs, weights, sigma, geo, rgb, nullptr, M, in_dim, hidden, out1,
                       hidden_color, n_blocks, smem, stream);
}
#endif  // NGP_IN

// ---------------------------------------------------------------- backward
//
// K4 backward (field_bwd + field_bwd_reduce), the fp32 route: replaces
// JAX's autodiff of models/mlp.py:mlp_apply through _sigma_head and
// ngp_color, with trunc_exp's clamped VJP (ops/activation.py:24) and the
// sigmoid.  Given feat [M, IN], dirs [M, 3], the flat weights and the
// cotangents g_sigma [M] and g_rgb [M, 3], it returns g_feat [M, IN] and
// g_weights [N_W] (fp32).  No gradient flows to dirs (SH has no parameters,
// rays carry none).  In fp32 mlp_apply rounds nowhere between layers and
// neither does this kernel; the bf16 route, with JAX's bf16 rounding
// points, runs on the tensor cores (field_mma_bwd_full.cu).
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
// cudaFuncSetAttribute) holds the weights, the block's fp32
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

// One layer's backward inside the block.  act: this layer's input rows
// ([K][T]); g_out: this thread's output cotangent; g_in: its input
// cotangent, zeroed where the input's ReLU was off when MASK.
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
__global__ void __launch_bounds__(128, 1)
    field_bwd(const float* __restrict__ feat, const float* __restrict__ dirs,
              const float* __restrict__ weights, const float* __restrict__ g_sigma,
              const float* __restrict__ g_rgb, float* __restrict__ g_feat,
              float* __restrict__ partials, long long M) {
  using D = FieldDims<IN, HID, OUT1, HC>;
  constexpr int CIN = D::CIN, T = D::T, LD = D::LD, N_W = D::N_W;
  extern __shared__ float smem[];
  float* w_s = smem;
  float* dw_s = w_s + N_W;
  float* act = dw_s + N_W;
  float* cot = act + D::ACT_ROWS * T;
  constexpr bool bf16 = false;  // the fp32 route (bf16: field_mma_bwd_full.cu)
  for (int i = threadIdx.x; i < N_W; i += T) {
    w_s[i] = weights[i];
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
      for (int k = 0; k < CIN; ++k) act[k * T + t] = c[k];
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
        gc3[j] = g * (s * (1.0f - s));
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
    gh[0] = (valid ? g_sigma[m] : 0.0f) * expf(ngp_clip(h0, -15.0f, 15.0f));
#pragma unroll
    for (int j = 1; j < OUT1; ++j) gh[j] = g_in[SH_DIM + j - 1];
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

// Sums the blocks' partials in block order.
static __global__ void field_bwd_reduce(const float* __restrict__ partials, int n_blocks, int n_w,
                                 float* __restrict__ g_weights) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_w) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long long)b * n_w + e];
  g_weights[e] = s;
}

template <int IN, int HID, int OUT1, int HC>
int launch_field_bwd(const void* feat, const void* dirs, const void* weights,
                     const void* g_sigma, const void* g_rgb, void* g_feat, void* partials,
                     void* g_weights, long long M, int n_blocks, cudaStream_t s) {
  using D = FieldDims<IN, HID, OUT1, HC>;
  auto kernel = field_bwd<IN, HID, OUT1, HC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)D::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, D::T, D::SMEM, s>>>(
      (const float*)feat, (const float*)dirs, (const float*)weights, (const float*)g_sigma,
      (const float*)g_rgb, (float*)g_feat, (float*)partials, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  field_bwd_reduce<<<ngp_blocks(D::N_W, 256), 256, 0, s>>>((const float*)partials, n_blocks,
                                                           D::N_W, (float*)g_weights);
  NGP_RETURN_LAST_ERROR();
}

#ifndef NGP_IN
#define NGP_EXTERN(IN, HID, OUT1, HC) \
  extern template int launch_field_bwd<IN, HID, OUT1, HC>(                                  \
      const void*, const void*, const void*, const void*, const void*, void*, void*, void*,  \
      long long, int, cudaStream_t);
NGP_FIELD_WIDTHS(NGP_EXTERN)
#undef NGP_EXTERN

// partials: [n_blocks, N_W] fp32 scratch; n_blocks >= 1 blocks of 128 threads.
extern "C" int ngp_field_bwd(const void* feat, const void* dirs, const void* weights,
                             const void* g_sigma, const void* g_rgb, void* g_feat,
                             void* partials, void* g_weights, long long M, int n_blocks,
                             int in_dim, int hidden, int out1, int hidden_color,
                             void* stream) {
  if (M == 0 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return launch_field_bwd<IN, HID, OUT1, HC>(feat, dirs, weights, g_sigma, g_rgb, g_feat,   \
                                               partials, g_weights, M, n_blocks, s);
  NGP_FIELD_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}
#else
template int launch_field<NGP_IN, NGP_HID, NGP_OUT1, NGP_HC>(const void*, const void*,
                                                             const void*, void*, void*, void*,
                                                             void*, long long, int, long long,
                                                             cudaStream_t);
template int launch_field_bwd<NGP_IN, NGP_HID, NGP_OUT1, NGP_HC>(
    const void*, const void*, const void*, const void*, const void*, void*, void*, void*, long long,
    int, cudaStream_t);
#endif  // NGP_IN
