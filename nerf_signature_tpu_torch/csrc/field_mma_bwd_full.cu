// K4's full backward on the tensor cores (bf16): field_mma_bwd_full +
// field_mma_bwd_reduce, the clean train step's g_feat and weight gradient.
//
// Replaces JAX's autodiff of nerf_signature_tpu/models/mlp.py:mlp_apply as
// models/ngp.py:_sigma_head and ngp_color call it (with
// ops/activation.py:_trunc_exp_bwd and the sigmoid): given feat [M, IN],
// dirs [M, 3], the packed bf16 weights and the cotangents g_sigma [M] and
// g_rgb [M, 3], it returns g_feat [M, IN] and the gradient of the five
// weight matrices in mlp_flat order (fp32).  The recompute and the input
// cotangents are field_mma.cuh's bwd_chain, the feature-only kernel's
// fragments; rounding points (1)-(3): field_mma.cuh.
//
// What bounds it on the H100: bytes.  At the clean step's shapes (M =
// 524,288 uncompacted samples, 8% with a nonzero cotangent) it must read
// every cotangent and write every g_feat row (132 B a sample), and read the
// features and directions of the live samples: 0.024 ms at 3.35 TB/s; the
// flops of the live samples (6 a weight) take less on the tensor cores.
//
// Design:
// - a persistent grid of one 256-thread block an SM (8 warps; 202 KB of
//   shared memory at full width: the packed weights, the block's fp32
//   weight gradient in the packed layout, the staging of one block tile).
//   At IN = 128 a block tile of 8 warps would stage 163,840 B, 272,960 B
//   in all, past the 232,448 B a block may have; there the block runs 4
//   warps (FullDims): 191,008 B, the same code with half the live tiles in
//   flight.  (Keeping 8 warps would need layer 0's activation read back
//   from global memory and its weight gradient kept in per-block partial
//   rows there: a second path through the dW pass for one width.)
// - the block walks chunks of 32 warp tiles (512 samples).  All threads
//   read the chunk's cotangents (the next chunk's are loaded while this one
//   runs) and vote a 32-bit mask of the warp tiles with any nonzero
//   cotangent; dead tiles get a zero g_feat and load no features;
// - the live tiles go 8 at a time, in chunk order, one a warp: the warp
//   loads its tile's features as bf16 A fragments, runs bwd_chain and
//   stages, as bf16 in shared memory ([sample][unit], rows padded so
//   ldmatrix is conflict-free), each layer's input activation and output
//   cotangent, the C/A fragments it already holds;
// - after a barrier the block adds dW[k][j] += sum_s act[s][k] cot[s][j]
//   over the staged tiles: mma.sync m16n8k16 with the samples as the k
//   dimension, A = act^T and B = cot both by ldmatrix.trans from the
//   staging.  The 76 m16n8 tiles of dW (full width) are dealt round-robin
//   to the warps; each keeps its tiles' fp32 accumulators in shared memory
//   (the packed layout's row strides make the C fragments' float2 accesses
//   conflict-free), so the chain's registers do not grow;
// - deterministic, no atomics: a dW tile is owned by one warp and summed
//   over the tiles in chunk order; each block writes its partial to
//   [n_blocks, N_PACK] and field_mma_bwd_reduce sums them in block order,
//   rounds once to bf16 (3) and reads each mlp_flat entry from its packed
//   position (models/ngp.py:_mma_grad_index), so Wc0' row 16 (facing o[0],
//   which the colour MLP never sees) and the padding get no gradient.

#include "field_mma.cuh"

namespace {

constexpr int CHUNK_TILES = 32;  // warp tiles a liveness chunk: one bit each
constexpr int CHUNK = 16 * CHUNK_TILES;

// Units of the staged input activation and output cotangent of layer l.
template <class B>
__host__ __device__ constexpr int act_units(int l) {
  return l == L_S0 ? B::KIN : l == L_S1 ? B::HID : l == L_C0 ? SH_DIM + B::OUT1 : B::HC;
}
template <class B>
__host__ __device__ constexpr int cot_units(int l) {
  return l == L_S0 ? B::HID : l == L_S1 ? B::OUT1 : l == L_C2 ? 8 : B::HC;
}
// Offsets (bf16 elements) of layer l's staged activation and cotangent, each
// [16 * WARPS samples][pad_ld(units)].
template <class B>
__host__ __device__ constexpr int act_off(int l) {
  int o = 0;
  for (int i = 0; i < l; ++i) o += 16 * B::WARPS * pad_ld(act_units<B>(i));
  return o;
}
template <class B>
__host__ __device__ constexpr int cot_off(int l) {
  int o = act_off<B>(L_C2 + 1);
  for (int i = 0; i < l; ++i) o += 16 * B::WARPS * pad_ld(cot_units<B>(i));
  return o;
}
// Layer l's weight gradient in the packed layout: offset and row stride.
template <class B>
__host__ __device__ constexpr int dw_off(int l) {
  return l == L_S0 ? 0 : l == L_S1 ? B::O_S1 : l == L_C0 ? B::O_C0 : l == L_C1 ? B::O_C1 : B::O_C2;
}
template <class B>
__host__ __device__ constexpr int dw_ld(int l) {
  return l == L_S0 ? B::LD_S0
                   : l == L_S1 ? B::LD_S1 : l == L_C0 ? B::LD_C0 : l == L_C1 ? B::LD_C1 : B::LD_C2;
}
// Index of layer l's first m16n8 dW tile in the block's round-robin order.
template <class B>
__host__ __device__ constexpr int first_tile(int l) {
  int f = 0;
  for (int i = 0; i < l; ++i) f += act_units<B>(i) / 16 * (cot_units<B>(i) / 8);
  return f;
}

// The block plan: one 16-row warp tile a warp, WARPS warps a block tile;
// SPT samples a thread in the liveness vote, TPT threads a warp tile.
template <class B>
struct FullPlan : B {
  static constexpr int SPT = CHUNK / B::THREADS, TPT = 16 / SPT, TPW = 32 / TPT;
  static_assert(B::RT == 1 && CHUNK % B::THREADS == 0 && 16 % SPT == 0 &&
                    TPW * B::WARPS == CHUNK_TILES,
                "a chunk's vote: whole warp tiles a warp");
  static constexpr int STAGE = cot_off<B>(L_C2 + 1);  // bf16 elements
  static_assert(STAGE % 8 == 0, "16-byte staging rows");
  // weights (bf16), the block's dW (fp32, packed layout), staging, votes
  static constexpr size_t SMEM = (size_t)B::N_PACK * 6 + (size_t)STAGE * 2 + 2 * B::WARPS * 4;
};

// 8 warps a block where that plan's shared memory fits a block, else 4
// (IN = 128: 272,960 B against 191,008 B).
template <int IN, int HID, int OUT1, int HC, int WARPS>
using FullOf = FullPlan<MmaDims<IN, HID, OUT1, HC, 1, WARPS, 1>>;
template <int IN, int HID, int OUT1, int HC>
using FullDims = std::conditional_t<(FullOf<IN, HID, OUT1, HC, 8>::SMEM <= MAX_BLOCK_SMEM),
                                    FullOf<IN, HID, OUT1, HC, 8>, FullOf<IN, HID, OUT1, HC, 4>>;

// bwd_chain's Stage: writes a 16-row tile's A fragments to the block
// tile's staging, rows [row, row + 16) of the layer's array.
template <class D>
struct SmemStage {
  __nv_bfloat16* stage;
  int row, g, t;

  template <int OFF, int LD, int UNITS, int KB>
  __device__ __forceinline__ void put(const uint32_t (&a)[KB][4]) const {
    static_assert((KB - 1) * 16 < UNITS && UNITS <= KB * 16, "one k16 fragment a 16 units");
    uint32_t* p = reinterpret_cast<uint32_t*>(stage + OFF + (row + g) * LD + 2 * t);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      p[kb * 8] = a[kb][0];           // row g, columns 16 kb + 2t, +1
      p[4 * LD + kb * 8] = a[kb][1];  // row g + 8
      if (kb * 16 + 8 < UNITS) {      // columns 16 kb + 8 + 2t, +1
        p[kb * 8 + 4] = a[kb][2];
        p[4 * LD + kb * 8 + 4] = a[kb][3];
      }
    }
  }
  template <int L, int KB>
  __device__ __forceinline__ void act(int, const uint32_t (&a)[KB][4]) const {
    put<act_off<D>(L), pad_ld(act_units<D>(L)), act_units<D>(L)>(a);
  }
  template <int L, int KB>
  __device__ __forceinline__ void cot(int, const uint32_t (&a)[KB][4]) const {
    put<cot_off<D>(L), pad_ld(cot_units<D>(L)), cot_units<D>(L)>(a);
  }
};

// g_sigma and g_rgb of the SPT samples from m0 (zeros past M).
template <int SPT>
__device__ __forceinline__ void load_cots(const float* __restrict__ g_sigma,
                                          const float* __restrict__ g_rgb, long long m0,
                                          long long M, float (&v)[4 * SPT]) {
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const long long m = m0 + s;
    const bool ok = m < M;
    v[4 * s] = ok ? g_sigma[m] : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[4 * s + 1 + c] = ok ? g_rgb[m * 3 + c] : 0.0f;
  }
}

// Position of the n-th (from 0) set bit of mask.
__device__ __forceinline__ int nth_bit(uint32_t mask, int n) {
  for (int i = 0; i < n; ++i) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

// One live warp tile: its features as bf16 A fragments (rows past M zero),
// its directions, then the chain, staging into rows [16 warp, +16).
template <class D>
__device__ __forceinline__ void live_tile(const float* __restrict__ feat,
                                          const float* __restrict__ dirs, uint32_t w,
                                          const float* __restrict__ g_sigma,
                                          const float* __restrict__ g_rgb,
                                          float* __restrict__ g_feat, __nv_bfloat16* stage,
                                          long long row0, long long M, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float dv[1][2][3];
  load_dirs(dirs, row0, g, M, dv);
  uint32_t ax[1][D::KIN / 16][4];
#pragma unroll
  for (int kt = 0; kt < D::KIN / 16; ++kt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = row0 + g + 8 * hh;
      const float2* p = reinterpret_cast<const float2*>(feat + (m < M ? m : 0) * D::IN +
                                                        kt * 16 + 2 * t);
      const float2 x = m < M ? __ldg(p) : make_float2(0.0f, 0.0f);
      ax[0][kt][hh] = pack_bf16(x.x, x.y);
      if (kt * 16 + 8 < D::IN) {
        const float2 y = m < M ? __ldg(p + 4) : make_float2(0.0f, 0.0f);
        ax[0][kt][2 + hh] = pack_bf16(y.x, y.y);
      } else {
        ax[0][kt][2 + hh] = 0u;
      }
    }
  bwd_chain<D>(ax, dv, w, lane, row0, M, g_sigma, g_rgb, g_feat,
               SmemStage<D>{stage, 16 * warp, g, t});
}

// Layer L's share of the dW pass: this warp's m16n8 tiles of dW, each
// += act^T (16 units x 16 n_k samples) @ cot (16 n_k samples x 8 units).
template <class D, int L>
__device__ __forceinline__ void dw_layer(const __nv_bfloat16* stage, float* dw, int warp,
                                         int lane, int n_k) {
  constexpr int NT = cot_units<D>(L) / 8, TILES = act_units<D>(L) / 16 * NT;
  constexpr int ALD = pad_ld(act_units<D>(L)), GLD = pad_ld(cot_units<D>(L)), WLD = dw_ld<D>(L);
  const uint32_t a_base = smem_u32(stage + act_off<D>(L));
  const uint32_t g_base = smem_u32(stage + cot_off<D>(L));
  const int q = lane >> 3, r8 = lane & 7, g = lane >> 2, t = lane & 3;
  for (int i = (warp + D::WARPS - first_tile<D>(L) % D::WARPS) % D::WARPS; i < TILES;
       i += D::WARPS) {
    const int mi = i / NT, nj = i % NT;
    float* c = dw + dw_off<D>(L) + (mi * 16 + g) * WLD + nj * 8 + 2 * t;
    const float2 c0 = *reinterpret_cast<const float2*>(c);
    const float2 c1 = *reinterpret_cast<const float2*>(c + 8 * WLD);
    float acc[4] = {c0.x, c0.y, c1.x, c1.y};
    for (int k = 0; k < n_k; ++k) {
      uint32_t a[4], b[2];
      // A fragments (units g / g+8, samples 2t..): matrices (samples 0-7,
      // units 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15), transposed
      ldsm_x4_t(a, a_base + 2u * (uint32_t)((16 * k + (q >> 1) * 8 + r8) * ALD + 16 * mi +
                                            (q & 1) * 8));
      // B fragments (samples 2t.., unit g): samples 0-7 and 8-15, transposed
      ldsm_x2_t(b, g_base + 2u * (uint32_t)((16 * k + (q & 1) * 8 + r8) * GLD + 8 * nj));
      mma16816(acc, a, b[0], b[1]);
    }
    *reinterpret_cast<float2*>(c) = make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(c + 8 * WLD) = make_float2(acc[2], acc[3]);
  }
}

template <class D>
__global__ void __launch_bounds__(D::THREADS, 1)
    field_mma_bwd_full(const float* __restrict__ feat, const float* __restrict__ dirs,
                       const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ g_sigma,
                       const float* __restrict__ g_rgb, float* __restrict__ g_feat,
                       float* __restrict__ partials, long long M) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dw = reinterpret_cast<float*>(smem + 2 * D::N_PACK);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + 6 * D::N_PACK);
  uint32_t* votes = reinterpret_cast<uint32_t*>(smem + 6 * D::N_PACK + 2 * D::STAGE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t w = smem_u32(smem);
  stage_weights<D>(wpack, smem);
  for (int i = threadIdx.x; i < D::N_PACK; i += D::THREADS) dw[i] = 0.0f;
  const long long n_chunks = (M + CHUNK - 1) / CHUNK;
  long long chunk = blockIdx.x;
  float cots[4 * D::SPT];
  load_cots<D::SPT>(g_sigma, g_rgb, chunk * CHUNK + (long long)threadIdx.x * D::SPT, M, cots);

  for (int it = 0; chunk < n_chunks; chunk += gridDim.x, ++it) {
    // the chunk's live warp tiles: any nonzero cotangent among its 16 samples
    bool live = false;
#pragma unroll
    for (int i = 0; i < 4 * D::SPT; ++i) live |= cots[i] != 0.0f;
    const uint32_t vote = __ballot_sync(0xffffffffu, live);
    uint32_t bits = 0u;
#pragma unroll
    for (int q = 0; q < D::TPW; ++q)
      bits |= ((vote >> (q * D::TPT)) & ((1u << D::TPT) - 1u)) ? 1u << q : 0u;
    if (lane == 0) votes[(it & 1) * D::WARPS + warp] = bits << (warp * D::TPW);
    __syncthreads();  // (double-buffered votes: the next write is two chunks on)
    uint32_t mask = 0u;
#pragma unroll
    for (int i = 0; i < D::WARPS; ++i) mask |= votes[(it & 1) * D::WARPS + i];
    const long long base = chunk * CHUNK;
    load_cots<D::SPT>(g_sigma, g_rgb,
                      base + (long long)gridDim.x * CHUNK + (long long)threadIdx.x * D::SPT, M,
                      cots);
    // dead tiles: a zero g_feat, no features read
    constexpr int P = D::IN / 4;
    for (int i = threadIdx.x; i < CHUNK * P; i += D::THREADS) {
      const int r = i / P;
      const long long m = base + r;
      if (!((mask >> (r >> 4)) & 1u) && m < M)
        reinterpret_cast<float4*>(g_feat + m * D::IN)[i % P] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    // live tiles, WARPS at a time in chunk order, one a warp; then the
    // block adds their outer products to dW
    const int n_live = __popc(mask);
    for (int first = 0; first < n_live; first += D::WARPS) {
      const int n_k = min(D::WARPS, n_live - first);
      if (warp < n_k)
        live_tile<D>(feat, dirs, w, g_sigma, g_rgb, g_feat, stage,
                     base + 16 * nth_bit(mask, first + warp), M, warp, lane);
      __syncthreads();
      dw_layer<D, L_S0>(stage, dw, warp, lane, n_k);
      dw_layer<D, L_S1>(stage, dw, warp, lane, n_k);
      dw_layer<D, L_C0>(stage, dw, warp, lane, n_k);
      dw_layer<D, L_C1>(stage, dw, warp, lane, n_k);
      dw_layer<D, L_C2>(stage, dw, warp, lane, n_k);
      __syncthreads();  // the staging is refilled next
    }
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(partials + (long long)blockIdx.x * D::N_PACK);
  const float4* src = reinterpret_cast<const float4*>(dw);
  for (int i = threadIdx.x; i < D::N_PACK / 4; i += D::THREADS) dst[i] = src[i];
}

// g_flat[e] = bf16(sum over blocks, in block order, of partials[b][index[e]]) (3).
__global__ void field_mma_bwd_reduce(const float* __restrict__ partials, int n_blocks,
                                     int n_pack, const int* __restrict__ index, int n_w,
                                     float* __restrict__ g_flat) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_w) return;
  const float* p = partials + index[e];
  float s = 0.0f;
#pragma unroll 16  // the loads go ahead of the adds, which keep block order
  for (int b = 0; b < n_blocks; ++b) s += p[(long long)b * n_pack];
  g_flat[e] = bf16_round(s);
}

template <int IN, int HID, int OUT1, int HC>
int launch_bwd_full(const void* feat, const void* dirs, const void* wpack, const void* g_sigma,
                    const void* g_rgb, void* g_feat, void* partials, const void* index,
                    void* g_flat, long long M, int n_blocks, long long smem, cudaStream_t s) {
  using D = FullDims<IN, HID, OUT1, HC>;
  static_assert(D::SMEM <= MAX_BLOCK_SMEM, "more shared memory than a block may have");
  if (smem != (long long)D::SMEM) return (int)cudaErrorInvalidValue;
  constexpr int n_w = FieldDims<IN, HID, OUT1, HC>::N_W;
  auto kernel = field_mma_bwd_full<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, D::THREADS, D::SMEM, s>>>(
      (const float*)feat, (const float*)dirs, (const __nv_bfloat16*)wpack, (const float*)g_sigma,
      (const float*)g_rgb, (float*)g_feat, (float*)partials, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  field_mma_bwd_reduce<<<ngp_blocks(n_w, 256), 256, 0, s>>>(
      (const float*)partials, n_blocks, D::N_PACK, (const int*)index, n_w, (float*)g_flat);
  NGP_RETURN_LAST_ERROR();
}

}  // namespace

// wpack: the packed bf16 weights (models/ngp.py:pack_mlp_mma); partials:
// [n_blocks, N_PACK] fp32 scratch, 16-byte aligned; index: int32 [n_weights],
// each mlp_flat entry's packed position; n_blocks >= 1 blocks of 256
// threads (128 at IN = 128; one an SM) with smem bytes of dynamic shared
// memory (models/ngp.py:mma_launch; any other size is refused).  feat
// 8-byte aligned, g_feat 16-byte aligned.  Widths: NGP_MMA_WIDTHS.
extern "C" int ngp_field_mma_bwd(const void* feat, const void* dirs, const void* wpack,
                                 const void* g_sigma, const void* g_rgb, void* g_feat,
                                 void* partials, const void* index, void* g_flat, long long M,
                                 int n_blocks, int in_dim, int hidden, int out1, int hidden_color,
                                 long long smem, void* stream) {
  if (n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return launch_bwd_full<IN, HID, OUT1, HC>(feat, dirs, wpack, g_sigma, g_rgb, g_feat,      \
                                              partials, index, g_flat, M, n_blocks, smem, s);
  NGP_MMA_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// The full backward's compiled plan at these widths (plan_of: threads, shared
// bytes, blocks an SM, registers, local bytes), for models/ngp.py:mma_plan.
template <int IN, int HID, int OUT1, int HC>
static int plan_at(long long* out) {
  using D = FullDims<IN, HID, OUT1, HC>;
  return plan_of<D>(field_mma_bwd_full<D>, out);
}

extern "C" int ngp_field_mma_bwd_plan(int in_dim, int hidden, int out1, int hidden_color,
                                      long long* out) {
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return plan_at<IN, HID, OUT1, HC>(out);
  NGP_MMA_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}
