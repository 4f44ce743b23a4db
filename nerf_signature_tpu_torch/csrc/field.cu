// K4: the NGP field heads, forward, fused (the fp32 route; the backward:
// field_bwd.cu and field_feat.cu).
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
// Every output still starts at 0.0f and adds fmaf over k ascending (the
// order of the one-thread-a-sample kernel it replaced), so sigma, geo and
// rgb are bit-equal to that kernel's.  In fp32 mlp_apply rounds nowhere
// between layers, and neither does this kernel.  The file is compiled with
// -fmad=false, so the SH polynomials round like the plain version; the
// products use explicit fmaf.

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
    tile_colour_mlp<CIN, HC, T>(P, Q, Wc0, Wc1, P);
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
#else
template int launch_field<NGP_IN, NGP_HID, NGP_OUT1, NGP_HC>(const void*, const void*,
                                                             const void*, void*, void*, void*,
                                                             void*, long long, int, long long,
                                                             cudaStream_t);
#endif  // NGP_IN
