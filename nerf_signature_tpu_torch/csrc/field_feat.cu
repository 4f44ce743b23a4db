// K4 backward without the weight gradient (field_bwd_feat): the watermark
// stage's frozen backbone.  Replaces JAX's autodiff of
// nerf_signature_tpu/models/mlp.py:mlp_apply (through _sigma_head, ngp_color,
// trunc_exp and the sigmoid) where the weights are a captured constant:
// nerf_signature_tpu/train/trainer_wtmk.py:_wm_step_loss differentiates the
// trainable subtree only, so the backbone's MLPs pass back the input
// cotangent alone, g_feat [M, IN] from g_sigma and g_rgb.  The fp32 route
// (bf16: the tensor cores, field_mma_bwd.cu).
//
// What bounds it on the H100: per sample the forward again and one
// transposed product a layer (4 flops a weight, 37 kFLOP) on the fp32 FMA
// units, against 284 B of inputs and outputs a sample: operations, at the
// kernel's own roof; the bytes are the least time.
//
// Design: the forward's tiling (field.cu:field_fwd, field_common.cuh:
// MicroTile) on tiles of 256 live samples, one 256-thread block an SM (the
// wrapper passes the count).  A block takes chunks of 256 samples from a
// global counter (taken in turn, not by a fixed stride, they spread the
// live samples over the blocks evenly), writes a zero g_feat for each
// sample whose cotangents are all zero (the padded slots of rays that hit
// little: half the watermark step's samples) and queues the others in
// shared memory; each full queue (and the last, partial one) is a tile.  Shared memory (223,808 B at IN = 64)
// holds the weights, the transposed weights the input cotangents read
// (Wc1^T, Wc0's geo rows, Ws1^T, Ws0^T: each product then loads 16 bytes of
// weights at once, as the forward does), the two activation buffers, the
// hidden layer's ReLU mask (one 64-bit word a sample) and the queue.  Per
// tile: the forward into P and Q (feat -> P, h -> Q with its mask saved,
// o -> P rows 15..30 with o[0] kept per sample, SH4 -> P rows 0..15,
// c1 -> Q, c2 -> P); per sample the colour output, the sigmoid's derivative
// and g2 = mask(c2) * (Wc2 gc3) over c2 in place; then the transposed
// products: g1 = mask(c1) * (Wc1 g2) over c1 in place (Q), gh[1:] =
// Wc0[16:31] g1 into P rows 0..15 (the SH rows of Wc0 are skipped:
// directions take no gradient), gh[0] from trunc_exp's clamped VJP per
// sample, gh1 = mask(h) * (Ws1 gh) into Q, and g_feat = Ws0 gh1 from the
// registers to memory.  Each sum starts at 0.0f and adds fmaf over j
// ascending, and a sample's sums do not depend on the samples it shares a
// tile with, so g_feat equals the one-thread-a-sample kernel's bit for
// bit, and field_bwd's (field_bwd.cu), whose zero-cotangent samples come
// out +0.  One thread a sample (the earlier design) held the
// forward's and the cotangents' state in registers and spilled at every
// width.  A file of its own so that nvcc builds it in parallel with
// field.cu.

#include <cuda_bf16.h>
#include <limits.h>

#include "common.cuh"
#include "field_common.cuh"

#define NGP_BWD_FEAT_T 256  // samples a tile = threads a block (models/ngp.py:SIMT_TILE)

template <int IN, int HID, int OUT1, int HC>
__global__ void __launch_bounds__(NGP_BWD_FEAT_T, 1)
    field_bwd_feat(const float* __restrict__ feat, const float* __restrict__ dirs,
                   const float* __restrict__ weights, const float* __restrict__ g_sigma,
                   const float* __restrict__ g_rgb, float* __restrict__ g_feat, long long M,
                   int* __restrict__ next_chunk) {
  constexpr int T = NGP_BWD_FEAT_T;
  using D = SimtDims<IN, HID, OUT1, HC, T, true>;
  using F = FieldDims<IN, HID, OUT1, HC>;
  static_assert(HID <= 64, "the ReLU mask is 64-bit");
  constexpr int CIN = D::CIN;
  extern __shared__ __align__(16) float smem[];
  float* P = smem;
  float* Q = P + D::ROWS * T;
  unsigned long long* mask_h = reinterpret_cast<unsigned long long*>(Q + D::ROWS * T);
  float* w_s = reinterpret_cast<float*>(mask_h + T);
  float* WT1 = w_s + D::N_W;        // [HC][HC]:    Wc1[k][j] at [j][k]
  float* WT0 = WT1 + HC * HC;       // [HC][OUT1]:  Wc0[15 + jj][j] at [j][jj], jj = 0 zero
  float* WTs1 = WT0 + HC * OUT1;    // [OUT1][HID]: Ws1[k][j] at [j][k]
  float* WTs0 = WTs1 + OUT1 * HID;  // [HID][IN]:   Ws0[k][j] at [j][k]
  const float* Ws0 = w_s;
  const float* Ws1 = Ws0 + F::N_S0;
  const float* Wc0 = Ws1 + F::N_S1;
  const float* Wc1 = Wc0 + F::N_C0;
  const float* Wc2 = Wc1 + F::N_C1;
  for (int i = threadIdx.x; i < D::N_W; i += T) w_s[i] = weights[i];
  const float* gWs0 = weights;
  const float* gWs1 = gWs0 + F::N_S0;
  const float* gWc0 = gWs1 + F::N_S1;
  const float* gWc1 = gWc0 + F::N_C0;
  for (int i = threadIdx.x; i < HC * HC; i += T) WT1[i] = gWc1[(i % HC) * HC + i / HC];
  for (int i = threadIdx.x; i < HC * OUT1; i += T) {
    const int j = i / OUT1, jj = i % OUT1;
    WT0[i] = jj == 0 ? 0.0f : gWc0[(SH_DIM - 1 + jj) * HC + j];
  }
  for (int i = threadIdx.x; i < OUT1 * HID; i += T) WTs1[i] = gWs1[(i % HID) * OUT1 + i / HID];
  for (int i = threadIdx.x; i < HID * IN; i += T) WTs0[i] = gWs0[(i % IN) * HID + i / IN];
  long long* queue = reinterpret_cast<long long*>(WTs0 + HID * IN);  // [2T] live samples
  int* scratch = reinterpret_cast<int*>(queue + 2 * T);  // [T / 32] warp counts, a chunk
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int queued = 0;  // queue[0:queued], the same in every thread
  bool scanning = true;
  __syncthreads();

  while (true) {
    // ---- queue the live samples of the chunks this block takes until a
    // tile is full: a sample whose cotangents are all zero has a zero
    // g_feat, written here
    while (scanning && queued < T) {
      if (t == 0) scratch[T / 32] = atomicAdd(next_chunk, 1);
      __syncthreads();
      const long long c0 = (long long)scratch[T / 32] * T;
      if (c0 >= M) {
        scanning = false;
        break;
      }
      const long long m = c0 + t;
      bool live = false;
      if (m < M) {
        live = g_sigma[m] != 0.0f || g_rgb[m * 3 + 0] != 0.0f || g_rgb[m * 3 + 1] != 0.0f ||
               g_rgb[m * 3 + 2] != 0.0f;
        if (!live) {
          float4* out = reinterpret_cast<float4*>(g_feat + m * IN);
#pragma unroll
          for (int k = 0; k < IN / 4; ++k) out[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (lane == 0) scratch[warp] = __popc(ballot);
      __syncthreads();
      int at = queued, total = 0;
#pragma unroll
      for (int w = 0; w < T / 32; ++w) {
        at += w < warp ? scratch[w] : 0;
        total += scratch[w];
      }
      if (live) queue[at + __popc(ballot & ((1u << lane) - 1u))] = m;
      queued += total;
      __syncthreads();
    }
    if (queued == 0) break;
    // ---- a tile of the first n queued samples, thread t taking sample t
    const int n = queued < T ? queued : T;
    const bool valid = t < n;
    const long long m = valid ? queue[t] : 0;
    const float gs = valid ? g_sigma[m] : 0.0f;
    const float gr0 = valid ? g_rgb[m * 3 + 0] : 0.0f;
    const float gr1 = valid ? g_rgb[m * 3 + 1] : 0.0f;
    const float gr2 = valid ? g_rgb[m * 3 + 2] : 0.0f;
    // ---- the forward, recomputed, with h's ReLU mask and o[0] kept
    tile_feat<IN, T>(feat, m, valid, P);
    tile_sigma_mlp<IN, HID, OUT1, T>(P, Q, Ws0, Ws1);
    const float h0 = P[(SH_DIM - 1) * T + t];
    {
      unsigned long long mh = 0ull;
#pragma unroll
      for (int k = 0; k < HID; ++k) mh |= (Q[k * T + t] > 0.0f ? 1ull : 0ull) << k;
      mask_h[t] = mh;
    }
    tile_sh4<T>(dirs, m, valid, P);
    tile_colour_mlp<CIN, HC, T>(P, Q, Wc0, Wc1, P);
    // ---- per sample: the colour output's cotangent, then g2 over c2
    {
      float c3[3];
      colour_logits<HC, T>(P, Wc2, c3);
      const float gr[3] = {gr0, gr1, gr2};
      float gc3[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float s = 1.0f / (1.0f + expf(-c3[j]));
        gc3[j] = gr[j] * (s * (1.0f - s));
      }
#pragma unroll 8
      for (int k = 0; k < HC; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) acc = fmaf(Wc2[k * 3 + j], gc3[j], acc);
        P[k * T + t] = P[k * T + t] > 0.0f ? acc : 0.0f;
      }
    }
    __syncthreads();
    // ---- the input cotangents, layer by layer
    // g1 = mask(c1) * (Wc1 g2), over c1
    tile_layer<T, HC, HC>(P, WT1, Q, [Q](float v, int n, int s) {
      return Q[n * T + s] > 0.0f ? v : 0.0f;
    });
    __syncthreads();
    tile_layer<T, OUT1, HC>(Q, WT0, P, Same());  // gh[1:] = Wc0[16:31] g1 (gh[0]: next)
    __syncthreads();
    P[t] = gs * expf(ngp_clip(h0, -15.0f, 15.0f));  // trunc_exp's clamped VJP
    __syncthreads();
    // gh1 = mask(h) * (Ws1 gh)
    tile_layer<T, HID, OUT1>(P, WTs1, Q, [mask_h](float v, int n, int s) {
      return (mask_h[s] >> n) & 1ull ? v : 0.0f;
    });
    __syncthreads();
    {
      using MT = MicroTile<T, IN>;  // g_feat = Ws0 gh1
      MT mt;
      float acc[MT::RM][MT::RN];
      mt.template mm<HID>(Q, WTs0, acc);
#pragma unroll
      for (int i = 0; i < MT::RM; ++i) {
        if (mt.sample(i) >= n) continue;
        float* row = g_feat + queue[mt.sample(i)] * IN;
        if constexpr (MT::RN == 2) {
          *reinterpret_cast<float2*>(row + mt.out(0)) = make_float2(acc[i][0], acc[i][1]);
        } else {
#pragma unroll
          for (int h = 0; h < MT::RN / 4; ++h)
            *reinterpret_cast<float4*>(row + mt.out(4 * h)) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                            acc[i][4 * h + 3]);
        }
      }
    }
    // ---- dequeue the tile: the rest (fewer than T) to the front
    __syncthreads();
    const int rest = queued - n;
    if (t < rest) queue[t] = queue[T + t];
    queued = rest;
    __syncthreads();
  }
}

template <int IN, int HID, int OUT1, int HC>
int launch_field_bwd_feat(const void* feat, const void* dirs, const void* weights,
                          const void* g_sigma, const void* g_rgb, void* g_feat, long long M,
                          void* next_chunk, int n_blocks, long long smem, cudaStream_t s) {
  using D = SimtDims<IN, HID, OUT1, HC, NGP_BWD_FEAT_T, true>;
  if (smem != (long long)D::SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = field_bwd_feat<IN, HID, OUT1, HC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)D::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, NGP_BWD_FEAT_T, D::SMEM, s>>>(
      (const float*)feat, (const float*)dirs, (const float*)weights, (const float*)g_sigma,
      (const float*)g_rgb, (float*)g_feat, M, (int*)next_chunk);
  NGP_RETURN_LAST_ERROR();
}

#ifndef NGP_IN
#define NGP_EXTERN(IN, HID, OUT1, HC) \
  extern template int launch_field_bwd_feat<IN, HID, OUT1, HC>(                           \
      const void*, const void*, const void*, const void*, const void*, void*, long long, void*, \
      int, long long, cudaStream_t);
NGP_FIELD_WIDTHS(NGP_EXTERN)
#undef NGP_EXTERN

// n_blocks >= 1 blocks of 256 threads with smem bytes of dynamic shared
// memory each (models/ngp.py:simt_launch; any other size is refused);
// next_chunk: one int32, 0 at the launch (the blocks take chunks from it).
extern "C" int ngp_field_bwd_feat(const void* feat, const void* dirs, const void* weights,
                                  const void* g_sigma, const void* g_rgb, void* g_feat,
                                  long long M, int in_dim, int hidden, int out1,
                                  int hidden_color, void* next_chunk, int n_blocks,
                                  long long smem, void* stream) {
  if (M == 0) return 0;
  // chunk numbers (and the blocks' overshoot past the last) stay int32
  if (n_blocks < 1 || next_chunk == nullptr ||
      (M + NGP_BWD_FEAT_T - 1) / NGP_BWD_FEAT_T + n_blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return launch_field_bwd_feat<IN, HID, OUT1, HC>(feat, dirs, weights, g_sigma, g_rgb,      \
                                                    g_feat, M, next_chunk, n_blocks, smem, s);
  NGP_FIELD_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}
#else
template int launch_field_bwd_feat<NGP_IN, NGP_HID, NGP_OUT1, NGP_HC>(
    const void*, const void*, const void*, const void*, const void*, void*, long long, void*,
    int, long long, cudaStream_t);
#endif  // NGP_IN
