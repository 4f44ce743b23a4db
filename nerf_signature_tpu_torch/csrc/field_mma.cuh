// Shared by the tensor-core K4 kernels (field_mma.cu: the forward;
// field_mma_bwd.cu: the feature-only backward; field_mma_bwd_full.cu: the
// full backward with the weight gradient; one file each so that nvcc builds
// them in parallel): the weight layout and tile plan, the PTX wrappers
// (ldmatrix, mma.sync, cp.async), the layers and the backward chain.
//
// K4 on the tensor cores, the bf16 route: the fused field heads forward
// (field_mma_fwd), their backward to the features alone
// (field_mma_bwd_feat) and their full backward (field_mma_bwd_full).  The
// SIMT kernels of field.cu and field_feat.cu are the fp32 route.
//
// Replaces XLA's fusion of nerf_signature_tpu/models/mlp.py:mlp_apply as
// models/ngp.py:_sigma_head and ngp_color call it (with sh_encode at degree
// 4, trunc_exp and the sigmoid), and, for the backward, JAX's VJP of it:
// with the weights a captured constant (train/trainer_wtmk.py:_wm_step_loss)
// or with their gradient (the clean train step).
//
// Rounding: mlp_apply rounds its input to bf16, sums each dot in fp32
// (preferred_element_type) and rounds each layer's output to bf16 before the
// ReLU.  mma.sync m16n8k16 with bf16 operands and an fp32 accumulator,
// rounded to bf16 at each layer's output, rounds at the same points; only
// the order of the sum inside a dot differs from the plain version's.  JAX
// holds every cotangent of mlp_apply in bf16 too, so the backward rounds at
//   (1) the cotangent entering each mlp_apply, i.e. the transpose of its
//       final .astype(float32): g_rgb * s(1-s) for the colour MLP, and
//       [g_sigma * exp(clip(h0, -15, 15)), g_geo] for the sigma MLP;
//   (2) each layer's input cotangent, g_in = round(g_out @ W^T) (fp32 sum,
//       one rounding), before the previous ReLU's mask;
//   (3) each weight gradient, ONCE, after the fp32 sum over all M samples
//       (the bf16 dot's output, cast to fp32 by the transpose of
//       w.astype(bf16)): field_mma_bwd_full's reduce.
// The recomputed forward is the forward kernel's own, fragment for
// fragment, so the masks and activations the backward differentiates are
// those the loss saw.
//
// What bounds it on the H100: bytes.  At the serving shapes (1,048,576
// samples) the forward must move 163 MB (0.049 ms at 3.35 TB/s) and do 19.6
// GFLOP (0.02 ms at the bf16 tensor-core peak).
//
// Design:
// - a persistent grid, as many 128-thread blocks as fit on the SMs.  Each
//   block stages the packed bf16 weights (models/ngp.py:pack_mlp_mma) in
//   shared memory once; each warp walks tiles of samples: 32 in the forward
//   (two 16-row mma tiles, so that each B fragment serves both), 16 in the
//   backward, whose registers hold more (FwdDims, BwdDims);
// - a warp's feature tile comes in by cp.async in 16-byte pieces, double
//   buffered in the warp's own shared memory, and is read back as bf16 A
//   fragments;
// - activations never leave registers: a layer's fp32 accumulators (two n8
//   tiles) are rounded to bf16, ReLU'd and repacked as the next layer's k16 A
//   fragment, since m16n8k16's C and A layouts line up;
// - B fragments come by ldmatrix.trans from W [in, out] row-major (forward)
//   and by ldmatrix from the same copy as W^T (backward); rows are padded to
//   an odd number of 16-byte units, so the 8 rows of an ldmatrix fall in
//   distinct banks;
// - the colour input is [SH(16), o(16)], o's whole fragment, against
//   Wc0' [32, HC] whose row 16 is zero and whose rows 17-31 are Wc0's rows
//   16-30: [SH, o] @ Wc0' == [SH, o[1:]] @ Wc0 with no shift across lanes.
//   The last colour layer is padded to 8 outputs, IN = 8 to k = 16;
// - the backward recomputes the forward with the same fragments and keeps
//   each hidden layer's ReLU mask as one bit a fragment element (32 bits a
//   16-row tile for 64 units).  A layer's input cotangent has the C layout of
//   its forward activation, so the mask applies in registers.  A warp tile
//   whose cotangents are all zero writes zeros and loads no features.  The
//   full backward's block plan differs (field_mma_bwd_full.cu: 256-thread
//   blocks, features loaded straight into fragments, the weight gradient
//   from staged fragments);
// - each plan is chosen by whether its shared memory fits (FwdDims,
//   BwdDims, FullDims): at IN = 128 (16 x 8, 32 x 4) the forward carries
//   one 16-row tile a warp and the full backward runs 4 warps a block, so
//   that each stays within the 232,448 B a block may have; g_feat is
//   computed and written 64 columns at a time.
// Compiled with -fmad=false, so SH and the sigmoid round like the plain
// version.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "field_common.cuh"

namespace {

// row stride (elements) of an n-column bf16 matrix in shared memory
__host__ __device__ constexpr int pad_ld(int n) { return (n / 8) % 2 == 0 ? n + 8 : n; }

// The packed weights (the order of models/ngp.py:mma_layout), the warp
// tiles (RT 16-row mma tiles a warp carries together) and the block's plan:
// WARPS warps a block, at least MIN_BLOCKS blocks an SM (ptxas's register
// cap, 65536 / (32 * WARPS * MIN_BLOCKS)).
template <int IN_, int HID_, int OUT1_, int HC_, int RT_, int WARPS_, int MIN_BLOCKS_>
struct MmaDims {
  static constexpr int IN = IN_, HID = HID_, OUT1 = OUT1_, HC = HC_;
  static constexpr int RT = RT_, ROWS = 16 * RT_, WARPS = WARPS_, THREADS = 32 * WARPS_,
                       MIN_BLOCKS = MIN_BLOCKS_;
  static_assert(OUT1 == 16 && SH_DIM == 16, "the colour input [SH(16), o(16)] is two k16 blocks");
  static_assert((IN == 8 || IN == 16 || IN == 32 || IN == 64 || IN == 128) && HID % 16 == 0 &&
                    HID <= 64 &&
                    HC % 16 == 0 && HC <= 64,
                "fragment shapes and 32-bit ReLU masks");
  static_assert(ROWS <= 32, "a warp tile's liveness: one sample a lane");
  static constexpr int KIN = IN < 16 ? 16 : IN;
  static constexpr int LD_S0 = pad_ld(HID), LD_S1 = pad_ld(OUT1), LD_C0 = pad_ld(HC),
                       LD_C1 = pad_ld(HC), LD_C2 = pad_ld(8);
  static constexpr int O_S1 = KIN * LD_S0;
  static constexpr int O_C0 = O_S1 + HID * LD_S1;
  static constexpr int O_C1 = O_C0 + 2 * SH_DIM * LD_C0;
  static constexpr int O_C2 = O_C1 + HC * LD_C1;
  static constexpr int N_PACK = O_C2 + HC * LD_C2;  // bf16 elements
  static_assert(N_PACK % 8 == 0, "16-byte staging");
  // feature tile row stride (floats): the 8-byte fragment reads of rows g =
  // 0-3 (a half warp) fall in distinct banks (FLD = 8 or 8 mod 32: 24, 40,
  // 72 and 136 at IN = 16, 32, 64 and 128), and so do load_feat_tile's
  // 16-byte pieces
  static constexpr int FLD = IN == 8 ? IN : IN + 8;
  static constexpr int FTILE = ROWS * FLD;
  static constexpr size_t SMEM = (size_t)N_PACK * 2 + (size_t)WARPS * 2 * FTILE * 4;
};

// What dynamic shared memory an H100 SM holds (each block reserving 1 KB
// besides), the most one block may opt in to (every plan's SMEM is held to
// it at compile time), and the blocks of a plan an SM holds by its shared
// memory.  models/ngp.py:mma_launch mirrors the plans chosen from these.
constexpr size_t SM_SMEM = 233472, BLOCK_RESERVED = 1024, MAX_BLOCK_SMEM = 232448;
__host__ __device__ constexpr int sm_blocks(size_t smem) {
  return (int)(SM_SMEM / (smem + BLOCK_RESERVED));
}

// The forward carries two 16-row tiles a warp (each B fragment serves both)
// under a 168-register cap (3 blocks) while two blocks of that plan fit an
// SM; the backward holds the recomputed forward's masks and the cotangents
// besides, and carries one (-Xptxas -v on sm_90a, full width: two tiles
// spill at 255 registers, one spills at 128).  Where two blocks of the
// two-tile forward do not fit (IN = 128: 175,616 B, and layer 0's A
// fragments alone would take 64 registers), the forward carries one tile
// too.  A one-tile plan's register cap is the blocks of it an SM holds, at
// most 3 (2 at IN = 128: 105,984 B, so 255 registers).
template <int IN, int HID, int OUT1, int HC, int RT, int MIN_BLOCKS = 3>
using TilePlan = MmaDims<IN, HID, OUT1, HC, RT, 4, MIN_BLOCKS>;
template <int IN, int HID, int OUT1, int HC>
using OneTile = TilePlan<IN, HID, OUT1, HC, 1,
                         sm_blocks(TilePlan<IN, HID, OUT1, HC, 1>::SMEM) < 3
                             ? sm_blocks(TilePlan<IN, HID, OUT1, HC, 1>::SMEM)
                             : 3>;
template <int IN, int HID, int OUT1, int HC>
using FwdDims = std::conditional_t<(sm_blocks(TilePlan<IN, HID, OUT1, HC, 2>::SMEM) >= 2),
                                   TilePlan<IN, HID, OUT1, HC, 2>, OneTile<IN, HID, OUT1, HC>>;
template <int IN, int HID, int OUT1, int HC>
using BwdDims = OneTile<IN, HID, OUT1, HC>;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) @ b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block copies the packed bf16 weights into shared memory.
template <class D>
__device__ __forceinline__ void stage_weights(const __nv_bfloat16* __restrict__ wpack,
                                              unsigned char* smem) {
  const uint4* src = reinterpret_cast<const uint4*>(wpack);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < D::N_PACK / 8; i += D::THREADS) dst[i] = src[i];
}

// A warp's ROWS feature rows into its buffer (rows past M are zero-filled).
// A quarter warp's 8 pieces go to distinct banks: at IN = 32 and 64 they
// are 128 contiguous bytes of one row; at IN = 16 (two rows a quarter, FLD =
// 24) the row index's two low bits are swapped, so that the quarters take
// rows {0, 2}, {1, 3}, {4, 6}, {5, 7} of each 8.
template <class D>
__device__ __forceinline__ void load_feat_tile(float* buf, const float* __restrict__ feat,
                                               long long row0, long long M, int lane) {
  constexpr int PIECES = D::IN / 4;  // 16-byte pieces a row
  static_assert(D::ROWS * PIECES % 32 == 0, "whole 16-byte pieces a lane");
#pragma unroll
  for (int j = 0; j < D::ROWS * PIECES / 32; ++j) {
    const int i = j * 32 + lane;
    int r = i / PIECES;
    const int p = i % PIECES;
    if constexpr (PIECES == 4) r = (r & ~3) | ((r & 1) << 1) | ((r >> 1) & 1);
    const long long m = row0 + r;
    const bool ok = m < M;
    cp_async16(smem_u32(buf + r * D::FLD + p * 4), feat + (ok ? m : 0) * D::IN + p * 4,
               ok ? 16 : 0);
  }
}

// The tile's features as bf16 A fragments (IN = 8: k 8-15 are zero).
template <class D>
__device__ __forceinline__ void feat_frags(const float* buf, int g, int t,
                                           uint32_t (&a)[D::RT][D::KIN / 16][4]) {
#pragma unroll
  for (int r = 0; r < D::RT; ++r) {
#pragma unroll
    for (int kt = 0; kt < D::KIN / 16; ++kt) {
      const float* p0 = buf + (r * 16 + g) * D::FLD + kt * 16 + 2 * t;
      const float* p1 = p0 + 8 * D::FLD;
      const float2 x0 = *reinterpret_cast<const float2*>(p0);
      const float2 x1 = *reinterpret_cast<const float2*>(p1);
      a[r][kt][0] = pack_bf16(x0.x, x0.y);
      a[r][kt][1] = pack_bf16(x1.x, x1.y);
      if (kt * 16 + 8 < D::IN) {
        const float2 y0 = *reinterpret_cast<const float2*>(p0 + 8);
        const float2 y1 = *reinterpret_cast<const float2*>(p1 + 8);
        a[r][kt][2] = pack_bf16(y0.x, y0.y);
        a[r][kt][3] = pack_bf16(y1.x, y1.y);
      } else {
        a[r][kt][2] = 0u;
        a[r][kt][3] = 0u;
      }
    }
  }
}

// acc[r] = A[r] (16 x 16*KT) @ W (16*KT x 8*NT), W bf16 [in, out] in shared
// memory at byte address w with row stride LD.
template <int RT, int KT, int NT, int LD>
__device__ __forceinline__ void mma_layer(const uint32_t (&a)[RT][KT][4], uint32_t w,
                                          float (&acc)[RT][NT][4], int lane) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if constexpr (NT == 1) {
      uint32_t b[2];  // rows kt*16 + 0-7 and 8-15
      ldsm_x2_t(b, w + 2u * (uint32_t)((kt * 16 + (lane & 15)) * LD));
#pragma unroll
      for (int r = 0; r < RT; ++r) mma16816(acc[r][0], a[r][kt], b[0], b[1]);
    } else {
      static_assert(NT % 2 == 0, "n8 tiles in pairs");
      const int i = lane >> 3;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];  // (k 0-7, n), (k 8-15, n), (k 0-7, n+1), (k 8-15, n+1)
        ldsm_x4_t(b, w + 2u * (uint32_t)((kt * 16 + (i & 1) * 8 + (lane & 7)) * LD +
                                         (n + (i >> 1)) * 8));
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          mma16816(acc[r][n], a[r][kt], b[0], b[1]);
          mma16816(acc[r][n + 1], a[r][kt], b[2], b[3]);
        }
      }
    }
  }
}

// acc[r] (16 x 8*KT8, columns 8*KLO on) = G[r] (16 x 16*NK) @ W^T for W bf16
// [K, N] in shared memory at byte address w with row stride LD.  N8: the
// layer has 8 outputs, the reduction's k 8-15 are zero.
template <int KT8, int KLO, int LD, bool N8, int RT, int NK>
__device__ __forceinline__ void mma_layer_t(const uint32_t (&g)[RT][NK][4], uint32_t w,
                                            float (&acc)[RT][KT8][4], int lane) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int n = 0; n < KT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.0f;
#pragma unroll
  for (int nk = 0; nk < NK; ++nk) {
    if constexpr (N8) {
      static_assert(NK == 1 && KT8 % 2 == 0, "an 8-output layer");
      const int i = (lane >> 3) & 1;
#pragma unroll
      for (int j = 0; j < KT8; j += 2) {
        uint32_t b[2];  // b0 of output tiles j and j+1
        ldsm_x2(b, w + 2u * (uint32_t)(((KLO + j + i) * 8 + (lane & 7)) * LD));
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          mma16816(acc[r][j], g[r][0], b[0], 0u);
          mma16816(acc[r][j + 1], g[r][0], b[1], 0u);
        }
      }
    } else if constexpr (KT8 == 1) {
      const int i = (lane >> 3) & 1;
      uint32_t b[2];  // (rows KLO*8 + 0-7; n 0-7 and 8-15 of this k16 block)
      ldsm_x2(b, w + 2u * (uint32_t)((KLO * 8 + (lane & 7)) * LD + nk * 16 + i * 8));
#pragma unroll
      for (int r = 0; r < RT; ++r) mma16816(acc[r][0], g[r][nk], b[0], b[1]);
    } else {
      static_assert(KT8 % 2 == 0, "output tiles in pairs");
      const int i = lane >> 3;
#pragma unroll
      for (int j = 0; j < KT8; j += 2) {
        uint32_t b[4];  // (tile j, n 0-7), (tile j, n 8-15), (tile j+1, ...), ...
        ldsm_x4(b, w + 2u * (uint32_t)(((KLO + j + (i >> 1)) * 8 + (lane & 7)) * LD + nk * 16 +
                                       (i & 1) * 8));
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          mma16816(acc[r][j], g[r][nk], b[0], b[1]);
          mma16816(acc[r][j + 1], g[r][nk], b[2], b[3]);
        }
      }
    }
  }
}

// A layer's C fragments (NT n8 tiles) -> the next layer's A fragments (NT/2
// k16 blocks), rounded to bf16 and ReLU'd; returns the ReLU mask, bit 4j + e
// for element e of tile j.
template <int NT>
__device__ __forceinline__ uint32_t relu_frags(const float (&c)[NT][4], uint32_t (&a)[NT / 2][4]) {
  uint32_t mask = 0u;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = bf16_round(c[j][e]);
      mask |= (v[e] > 0.0f ? 1u : 0u) << (4 * j + e);
      v[e] = fmaxf(v[e], 0.0f);
    }
    a[j >> 1][(j & 1) * 2] = pack_bf16(v[0], v[1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
  }
  return mask;
}

// An input cotangent's C fragments -> A fragments: rounded to bf16 (2), then
// zeroed where the forward activation's ReLU was off.
template <int NT>
__device__ __forceinline__ void masked_frags(const float (&c)[NT][4], uint32_t mask,
                                             uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = ((mask >> (4 * j + e)) & 1u) ? bf16_round(c[j][e]) : 0.0f;
    a[j >> 1][(j & 1) * 2] = pack_bf16(v[0], v[1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
  }
}

// SH(16) of one direction: this lane's columns 2t, 2t+1 (lo) and 2t+8, 2t+9
// (hi), rounded to bf16 (the colour input's first k16 block).
__device__ __forceinline__ void sh_frag(const float (&d)[3], int t, uint32_t& lo, uint32_t& hi) {
  float s[SH_DIM];
  sh4(d[0], d[1], d[2], s);
  float v0 = s[0], v1 = s[1], v2 = s[8], v3 = s[9];
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    if (t == q) {
      v0 = s[2 * q];
      v1 = s[2 * q + 1];
      v2 = s[2 * q + 8];
      v3 = s[2 * q + 9];
    }
  }
  lo = pack_bf16(v0, v1);
  hi = pack_bf16(v2, v3);
}

// The directions of this lane's rows (g and g+8 of each 16-row tile).
template <int RT>
__device__ __forceinline__ void load_dirs(const float* __restrict__ dirs, long long row0, int g,
                                          long long M, float (&dv)[RT][2][3]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = row0 + r * 16 + g + 8 * hh;
#pragma unroll
      for (int c = 0; c < 3; ++c) dv[r][hh][c] = m < M ? dirs[m * 3 + c] : 0.0f;
    }
}

// The layers in the packed order (models/ngp.py:mma_layout).
enum Layer { L_S0 = 0, L_S1 = 1, L_C0 = 2, L_C1 = 3, L_C2 = 4 };

// Where the backward puts what a weight gradient needs: each layer's input
// activation and output cotangent as the bf16 A fragments of one 16-row
// tile (act<L>, cot<L>).  The forward and the feature-only backward keep
// nothing; field_mma_bwd_full.cu stages them in shared memory.
struct NoStage {
  template <int L, int KB>
  __device__ __forceinline__ void act(int, const uint32_t (&)[KB][4]) const {}
  template <int L, int KB>
  __device__ __forceinline__ void cot(int, const uint32_t (&)[KB][4]) const {}
};

// The sigma MLP's output o (rounded to bf16) and, with recompute, the masks.
template <class D, class Stage = NoStage>
__device__ __forceinline__ void sigma_mlp(const uint32_t (&ax)[D::RT][D::KIN / 16][4], uint32_t w,
                                          int lane, float (&o)[D::RT][2][4],
                                          uint32_t (&mask_h)[D::RT], const Stage& st = Stage()) {
  {
    float h[D::RT][D::HID / 8][4];
    mma_layer<D::RT, D::KIN / 16, D::HID / 8, D::LD_S0>(ax, w, h, lane);
    uint32_t ah[D::RT][D::HID / 16][4];
#pragma unroll
    for (int r = 0; r < D::RT; ++r) {
      mask_h[r] = relu_frags<D::HID / 8>(h[r], ah[r]);
      st.template act<L_S1>(r, ah[r]);
    }
    mma_layer<D::RT, D::HID / 16, 2, D::LD_S1>(ah, w + 2u * D::O_S1, o, lane);
  }
#pragma unroll
  for (int r = 0; r < D::RT; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][j][e] = bf16_round(o[r][j][e]);
}

// The colour MLP up to its last layer's fp32 sums c3 (cols 2t, 2t+1 of 8).
template <class D, class Stage = NoStage>
__device__ __forceinline__ void colour_mlp(const float (&dv)[D::RT][2][3],
                                           const float (&o)[D::RT][2][4], uint32_t w, int lane,
                                           int t, float (&c3)[D::RT][1][4],
                                           uint32_t (&mask_c1)[D::RT], uint32_t (&mask_c2)[D::RT],
                                           const Stage& st = Stage()) {
  uint32_t a2[D::RT][D::HC / 16][4];
  {
    uint32_t a1[D::RT][D::HC / 16][4];
    {
      uint32_t ac[D::RT][2][4];  // [SH(16), o(16)]
#pragma unroll
      for (int r = 0; r < D::RT; ++r) {
        sh_frag(dv[r][0], t, ac[r][0][0], ac[r][0][2]);
        sh_frag(dv[r][1], t, ac[r][0][1], ac[r][0][3]);
        ac[r][1][0] = pack_bf16(o[r][0][0], o[r][0][1]);
        ac[r][1][1] = pack_bf16(o[r][0][2], o[r][0][3]);
        ac[r][1][2] = pack_bf16(o[r][1][0], o[r][1][1]);
        ac[r][1][3] = pack_bf16(o[r][1][2], o[r][1][3]);
        st.template act<L_C0>(r, ac[r]);
      }
      float c1[D::RT][D::HC / 8][4];
      mma_layer<D::RT, 2, D::HC / 8, D::LD_C0>(ac, w + 2u * D::O_C0, c1, lane);
#pragma unroll
      for (int r = 0; r < D::RT; ++r) {
        mask_c1[r] = relu_frags<D::HC / 8>(c1[r], a1[r]);
        st.template act<L_C1>(r, a1[r]);
      }
    }
    float c2[D::RT][D::HC / 8][4];
    mma_layer<D::RT, D::HC / 16, D::HC / 8, D::LD_C1>(a1, w + 2u * D::O_C1, c2, lane);
#pragma unroll
    for (int r = 0; r < D::RT; ++r) {
      mask_c2[r] = relu_frags<D::HC / 8>(c2[r], a2[r]);
      st.template act<L_C2>(r, a2[r]);
    }
  }
  mma_layer<D::RT, D::HC / 16, 1, D::LD_C2>(a2, w + 2u * D::O_C2, c3, lane);
}

__device__ __forceinline__ float sigmoid_of(float v) { return 1.0f / (1.0f + expf(-v)); }

// g_feat's columns [8 KLO, 8 (KLO + KT8)) of one warp tile whose rows start
// at row0: round(g_h @ Ws0^T) over those columns (2), written for the rows
// before M.  agh1: the masked cotangent of layer 0's output.
template <class D, int KLO, int KT8>
__device__ __forceinline__ void feat_cotangent(const uint32_t (&agh1)[D::RT][D::HID / 16][4],
                                               uint32_t w, int lane, long long row0, long long M,
                                               float* __restrict__ g_feat) {
  const int g = lane >> 2, t = lane & 3;
  float gx[D::RT][KT8][4];
  mma_layer_t<KT8, KLO, D::LD_S0, false>(agh1, w, gx, lane);
#pragma unroll
  for (int r = 0; r < D::RT; ++r)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = row0 + r * 16 + g + 8 * hh;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < KT8; ++j)
        *reinterpret_cast<float2*>(g_feat + m * D::IN + 8 * (KLO + j) + 2 * t) =
            make_float2(bf16_round(gx[r][j][2 * hh]), bf16_round(gx[r][j][2 * hh + 1]));
    }
}

// The backward of one warp tile whose rows start at row0: the forward again
// with the forward kernel's fragments (keeping the ReLU masks), then the
// input cotangents layer by layer down to g_feat, which it writes (rows past
// M are skipped).  ax: the tile's features as A fragments; dv: its
// directions.  st receives each layer's activation and output cotangent.
template <class D, class Stage>
__device__ __forceinline__ void bwd_chain(const uint32_t (&ax)[D::RT][D::KIN / 16][4],
                                          const float (&dv)[D::RT][2][3], uint32_t w, int lane,
                                          long long row0, long long M,
                                          const float* __restrict__ g_sigma,
                                          const float* __restrict__ g_rgb,
                                          float* __restrict__ g_feat, const Stage& st) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < D::RT; ++r) st.template act<L_S0>(r, ax[r]);
  // ---- the forward again, with the same fragments; keep the masks
  float o[D::RT][2][4];
  uint32_t mask_h[D::RT], mask_c1[D::RT], mask_c2[D::RT];
  sigma_mlp<D>(ax, w, lane, o, mask_h, st);
  float c3[D::RT][1][4];
  colour_mlp<D>(dv, o, w, lane, t, c3, mask_c1, mask_c2, st);
  // ---- the colour MLP's cotangent (1): g_rgb * s(1-s), as an A fragment
  // over the last layer's 8 (padded to 16) outputs
  uint32_t agc[D::RT][1][4];
#pragma unroll
  for (int r = 0; r < D::RT; ++r) {
    float gc[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = row0 + r * 16 + g + 8 * hh;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 2 * t + q;
        const float gr = (m < M && col < 3) ? g_rgb[m * 3 + col] : 0.0f;
        const float s = sigmoid_of(bf16_round(c3[r][0][2 * hh + q]));
        gc[hh][q] = bf16_round(gr * (s * (1.0f - s)));
      }
    }
    agc[r][0][0] = pack_bf16(gc[0][0], gc[0][1]);
    agc[r][0][1] = pack_bf16(gc[1][0], gc[1][1]);
    agc[r][0][2] = 0u;
    agc[r][0][3] = 0u;
    st.template cot<L_C2>(r, agc[r]);
  }
  // ---- colour MLP, input cotangents (2)
  uint32_t agh[D::RT][1][4];
  {
    uint32_t ag1[D::RT][D::HC / 16][4];
    {
      uint32_t ag2[D::RT][D::HC / 16][4];
      {
        float acc[D::RT][D::HC / 8][4];
        mma_layer_t<D::HC / 8, 0, D::LD_C2, true>(agc, w + 2u * D::O_C2, acc, lane);
#pragma unroll
        for (int r = 0; r < D::RT; ++r) {
          masked_frags<D::HC / 8>(acc[r], mask_c2[r], ag2[r]);
          st.template cot<L_C1>(r, ag2[r]);
        }
      }
      float acc[D::RT][D::HC / 8][4];
      mma_layer_t<D::HC / 8, 0, D::LD_C1, false>(ag2, w + 2u * D::O_C1, acc, lane);
#pragma unroll
      for (int r = 0; r < D::RT; ++r) {
        masked_frags<D::HC / 8>(acc[r], mask_c1[r], ag1[r]);
        st.template cot<L_C0>(r, ag1[r]);
      }
    }
    // the cotangent of o: Wc0' rows 16-31; column 16 (o[0]'s, a zero row)
    // takes trunc_exp's clamped VJP of sigma instead (1)
    float go[D::RT][2][4];
    mma_layer_t<2, 2, D::LD_C0, false>(ag1, w + 2u * D::O_C0, go, lane);
#pragma unroll
    for (int r = 0; r < D::RT; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) go[r][j][e] = bf16_round(go[r][j][e]);
      if (t == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long m = row0 + r * 16 + g + 8 * hh;
          const float gs = m < M ? g_sigma[m] : 0.0f;
          go[r][0][2 * hh] = bf16_round(gs * expf(ngp_clip(o[r][0][2 * hh], -15.0f, 15.0f)));
        }
      }
      agh[r][0][0] = pack_bf16(go[r][0][0], go[r][0][1]);
      agh[r][0][1] = pack_bf16(go[r][0][2], go[r][0][3]);
      agh[r][0][2] = pack_bf16(go[r][1][0], go[r][1][1]);
      agh[r][0][3] = pack_bf16(go[r][1][2], go[r][1][3]);
      st.template cot<L_S1>(r, agh[r]);
    }
  }
  // ---- sigma MLP, input cotangents (2)
  uint32_t agh1[D::RT][D::HID / 16][4];
  {
    float acc[D::RT][D::HID / 8][4];
    mma_layer_t<D::HID / 8, 0, D::LD_S1, false>(agh, w + 2u * D::O_S1, acc, lane);
#pragma unroll
    for (int r = 0; r < D::RT; ++r) {
      masked_frags<D::HID / 8>(acc[r], mask_h[r], agh1[r]);
      st.template cot<L_S0>(r, agh1[r]);
    }
  }
  // g_feat in spans of at most 64 columns, so that the cotangent held in
  // registers stays at 32 floats a lane at IN = 128
  constexpr int SPAN = D::IN / 8 < 8 ? D::IN / 8 : 8;
  static_assert(D::IN / 8 <= 2 * SPAN, "one or two spans");
  feat_cotangent<D, 0, SPAN>(agh1, w, lane, row0, M, g_feat);
  if constexpr (D::IN / 8 > SPAN) feat_cotangent<D, SPAN, SPAN>(agh1, w, lane, row0, M, g_feat);
}

// Blocks of a persistent grid: as many as fit on the card's SMs, at most
// one warp per tile.  smem: the caller's dynamic shared bytes
// (models/ngp.py:mma_launch), refused unless they are the plan's.
template <class D, class Kernel>
int persistent_blocks(Kernel kernel, long long M, long long smem, int* blocks) {
  static_assert(D::SMEM <= MAX_BLOCK_SMEM, "more shared memory than a block may have");
  if (smem != (long long)D::SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, D::THREADS, D::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (M + D::ROWS - 1) / D::ROWS;
  const long long want = (tiles + D::WARPS - 1) / D::WARPS;
  const long long most = (long long)per_sm * sms;
  *blocks = (int)(want < most ? want : most);
  return 0;
}

// A compiled plan as the card's runtime reports it, nothing launched:
// out[0] threads a block, out[1] dynamic shared bytes, out[2] blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at those bytes), out[3]
// registers a thread and out[4] local (spill) bytes a thread
// (cudaFuncGetAttributes).
template <class D, class Kernel>
int plan_of(Kernel kernel, long long* out) {
  static_assert(D::SMEM <= MAX_BLOCK_SMEM, "more shared memory than a block may have");
  int per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, D::THREADS, D::SMEM);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = D::THREADS;
  out[1] = (long long)D::SMEM;
  out[2] = per_sm;
  out[3] = attr.numRegs;
  out[4] = (long long)attr.localSizeBytes;
  return 0;
}

}  // namespace
