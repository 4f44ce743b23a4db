// K8, the whole background colour of the bg-sphere model: the sphere point,
// the L-level 2D hash encoding, SH4 of the direction, bg_net (IN -> 64 -> 3,
// bias-free, ReLU) and the sigmoid, in one forward kernel (bg_color_fwd);
// backward, the gradients of the table and of both bg_net matrices in two
// kernels of one call: bg_color_bwd (the chain's backward per ray and each
// block's weight-gradient sums) and bg_finish (the sums of the blocks, and
// the table's gradient by row).
//
// Replaces nerf_signature_tpu/models/ngp.py:ngp_background (:211-229), which
// XLA fuses into a few fusions: ops/intersect.py:sph_from_ray,
// ops/hashenc.py:hash_encode_2d (_hash_encode_2d_impl, :448), ops/sh.py
// at degree 4, models/mlp.py:mlp_apply and the sigmoid, and their autodiff.
// The port ran it as K8's encode (hashenc_bg.cu) and ~60 launches of torch
// ops forward (~16 more backward) on a function of 24 inputs a ray.  Every
// file of K8 is compiled with -fmad=false; the matrix products' FMAs are
// written out (fmaf, ascending over the input), as K4's SIMT kernels write
// theirs.
//
// Roundings, those of mlp_apply and of its autograd (the bf16 chain, as
// field_mma.cuh lists them for K4):
//   forward: the concatenated input [features, SH] to bf16; fp32 sums;
//     each layer's output to bf16 before the ReLU; the last output to fp32
//     (exact) before the sigmoid;
//   backward: the sigmoid's cotangent g * (1 - s) * s to bf16 (the cast's
//     VJP); g_h1 = g_h W2^T to bf16, then the ReLU mask (h1 > 0); g_x =
//     g_h1 W1^T to bf16; its first L*F entries into the table, each
//     corner's cw * g rounded to bf16 (the row gather's VJP, as in K1);
//     dW2 = h1^T g_h and dW1 = x^T g_h1 summed in fp32 over all rays and
//     rounded to bf16 once.
// In fp32 nothing rounds between the operations.  The sum order of the
// products is not cuBLAS's, so the colour and the gradients match the chain
// to a stated tolerance, not bit for bit.
//
// What bounds it on the H100: neither bytes nor operations.  At 4096 rays
// and the defaults (L = 4, F = 2: IN = 24) the forward reads 24 B of rays
// a ray and the touched table rows, writes 12 B, and does ~1,700 FMAs a
// ray: ~14 MFLOP, 0.2 us at the fp32 rate; the backward ~3x that.  Both sit
// under a launch's floor, so the design's aim is one launch for what was
// ~60: everything per ray stays in registers and shared memory.
//
// Design:
// - Forward: one thread a ray, blocks of 128.  The packed weights (W1
//   [IN][64] then W2 [64][3], fp32, pre-rounded to bf16 values in bf16
//   mode: 6.9 KB at F = 2) are staged once a block in shared memory; every
//   thread reads the same weight at once (a broadcast).  The level loop
//   gathers the four corner rows, and each feature, rounded, goes straight
//   into the 64 fp32 sums of layer 1 (registers), then SH4's 16; then the
//   ReLU, layer 2 and the sigmoid.  No [N, IN] tensor exists.
// - Backward, bg_color_bwd: a persistent grid of G blocks (G = min(tiles,
//   SMs), fixed by N), block b taking tiles b, b + G, ... of T rays (T =
//   128, or 64 where the staging would not fit: L x F = 256).  Per tile,
//   each thread recomputes its ray's forward, staging x (rounded) in X
//   [IN][T + 1] and h1 in A [64][T + 1]; its g_h goes to G2 [3][T + 1] and
//   its g_h1 stays in registers, and it writes its ray's clipped sphere
//   point and g_x[:L*F] (rounded, level-major) to the scratch.  Then the
//   block's dW2 = A^T G2 (A holding h1), A is overwritten with g_h1, and
//   dW1 = X^T A: each entry is owned by one thread, an fmaf chain over the
//   tile's rays in order, stored into the block's row of partials [G][NW]
//   at its first tile and added to at each later one (a thread owns one
//   column of dW1 and sums 8 of its rows at once, one load of the column's
//   g_h1 a ray for 8 chains).  The row stride T + 1 keeps a warp's 32 reads
//   of 32 different rows in 32 banks.
// - Backward, bg_finish: its first blocks sum the G rows of partials in
//   block order (rounding once to bf16 in bf16 mode); the others build the
//   table's gradient by row ownership: a block of 16 warps owns 1024 / F
//   rows of one level and reads all rays (staged 1024 at a time in shared
//   memory, from the scratch's level-major rows: two contiguous reads);
//   each warp takes every 16th chunk of 32 rays, recomputes their four
//   corners at that level and adds the contributions that fall in the
//   block's rows into its own fp32 copy of them (the lanes of a row summed
//   first, pairwise by rank), and the 16 copies are summed in warp order
//   when every row is written once.  No float atomic anywhere: dW and the
//   table's gradient are bit-equal from run to run (for a given N on a
//   given card: G counts its SMs), no memset is needed, and the kernels
//   keep no state between calls (graph replays are safe).  Every block
//   reads every ray at its level ((2 + F) x 4 B): at 4096 rays and F = 2,
//   2^15 rows a level, 256 blocks read 16.8 MB from L2 in all.

#include "bg_sphere.cuh"
#include "field_common.cuh"

#define BG_HID 64
#define BG_OUT 3
#define BG_FWD_T 128
#define BG_KB 8  // rows of dW1 a thread sums at once

__device__ __forceinline__ float bg_round(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The F features of one (ray, level), as hash2d_fwd computes them.
template <typename T, int F>
__device__ __forceinline__ void bg_level(const T* __restrict__ table, const float (&xc)[2],
                                         const HashLevels& p, int l, unsigned int mask,
                                         float (&acc)[F]) {
  unsigned int idx[4];
  float cw[4];
  corners_2d(xc, p.res[l], mask, p.offset[l], idx, cw);
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float r[F];
    load_row<F>(table, idx[c], r);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(cw[c], r[f]));
  }
}

// SH4 of ray n's normalised direction (rays_d / |rays_d|).
__device__ __forceinline__ void bg_sh(const float* __restrict__ rays_d, long long n,
                                      float (&c)[SH_DIM]) {
  const float dx = rays_d[3 * n], dy = rays_d[3 * n + 1], dz = rays_d[3 * n + 2];
  const float nrm = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  sh4(__fdiv_rn(dx, nrm), __fdiv_rn(dy, nrm), __fdiv_rn(dz, nrm), c);
}

__device__ __forceinline__ float bg_sigmoid(float o) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-o)));
}

// The packed weights into shared memory.
__device__ __forceinline__ void bg_stage_weights(float* sw, const float* __restrict__ w,
                                                 int nw) {
  for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = w[i];
  __syncthreads();
}

// Layer 1's sums over ray n's input (each entry rounded, then into 64
// fmaf chains), the input also staged to X [IN][ld] column ``t`` when sx
// is given (the backward); xc gets the clipped sphere point; a dead ray
// (live false) adds zeros.
template <typename T, int F>
__device__ __forceinline__ void bg_layer1(const BgInput& in, const T* __restrict__ table,
                                          const HashLevels& p, const float* sw, long long n,
                                          bool live, int bf16, float (&acc)[BG_HID],
                                          float* sx, int ld, float (&xc)[2]) {
#pragma unroll
  for (int j = 0; j < BG_HID; ++j) acc[j] = 0.0f;
  xc[0] = xc[1] = 0.0f;
  if (live) {
    float x[2];
    bg_position(in, n, x);
    xc[0] = ngp_clip(x[0], 0.0f, 1.0f);
    xc[1] = ngp_clip(x[1], 0.0f, 1.0f);
  }
  const unsigned int mask = (1u << p.log2_size) - 1u;
  for (int l = 0; l < p.L; ++l) {
    float feat[F];
    bg_level<T, F>(table, xc, p, l, mask, feat);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int i = l * F + f;
      const float v = live ? bg_round(feat[f], bf16) : 0.0f;
      if (sx != nullptr) sx[i * ld + threadIdx.x] = v;
      const float* wr = sw + i * BG_HID;
#pragma unroll
      for (int j = 0; j < BG_HID; ++j) acc[j] = fmaf(v, wr[j], acc[j]);
    }
  }
  float c[SH_DIM];
  if (live) {
    bg_sh(in.rays_d, n, c);
  } else {
#pragma unroll
    for (int k = 0; k < SH_DIM; ++k) c[k] = 0.0f;
  }
  const int LF = p.L * F;
#pragma unroll
  for (int k = 0; k < SH_DIM; ++k) {
    const float v = bg_round(c[k], bf16);
    if (sx != nullptr) sx[(LF + k) * ld + threadIdx.x] = v;
    const float* wr = sw + (LF + k) * BG_HID;
#pragma unroll
    for (int j = 0; j < BG_HID; ++j) acc[j] = fmaf(v, wr[j], acc[j]);
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(BG_FWD_T)
    bg_color_fwd(BgInput in, const T* __restrict__ table, const float* __restrict__ w,
                 float* __restrict__ rgb, long long N, HashLevels p, int bf16) {
  extern __shared__ float sw[];  // W1 [IN][64], W2 [64][3]
  const int IN = p.L * F + SH_DIM;
  bg_stage_weights(sw, w, IN * BG_HID + BG_HID * BG_OUT);
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc[BG_HID], xc[2];
  bg_layer1<T, F>(in, table, p, sw, n, true, bf16, acc, nullptr, 0, xc);
  const float* w2 = sw + IN * BG_HID;
  float o[BG_OUT] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < BG_HID; ++j) {
    const float h = fmaxf(bg_round(acc[j], bf16), 0.0f);
#pragma unroll
    for (int k = 0; k < BG_OUT; ++k) o[k] = fmaf(h, w2[j * BG_OUT + k], o[k]);
  }
#pragma unroll
  for (int k = 0; k < BG_OUT; ++k) rgb[n * BG_OUT + k] = bg_sigmoid(bg_round(o[k], bf16));
}

template <typename T, int F>
__global__ void __launch_bounds__(128)
    bg_color_bwd(BgInput in, const T* __restrict__ table, const float* __restrict__ w,
                 const float* __restrict__ g_rgb, float* __restrict__ scratch,
                 float* __restrict__ partials, long long N, HashLevels p, int bf16) {
  extern __shared__ float smem[];
  const int LF = p.L * F, IN = LF + SH_DIM, NW1 = IN * BG_HID;
  const int NW = NW1 + BG_HID * BG_OUT;
  const int TT = blockDim.x, ld = TT + 1, t = threadIdx.x;
  float* sw = smem;                 // W1 [IN][64], W2 [64][3]
  float* sx = sw + NW;              // X [IN][ld]: the rounded inputs
  float* sa = sx + IN * ld;         // A [64][ld]: h1, then g_h1
  float* sg = sa + BG_HID * ld;     // G2 [3][ld]: g_h
  bg_stage_weights(sw, w, NW);
  const float* w2 = sw + NW1;
  float* part = partials + (long long)blockIdx.x * NW;
  const long long n_tiles = (N + TT - 1) / TT;
  bool first = true;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long n = tile * TT + t;
    const bool live = n < N;
    const int rays = (int)min((long long)TT, N - tile * TT);
    // the forward again: x -> X, h1 -> A (and registers), g_h -> G2
    float acc[BG_HID], xc[2];
    bg_layer1<T, F>(in, table, p, sw, n, live, bf16, acc, sx, ld, xc);
    float o[BG_OUT] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BG_HID; ++j) {
      const float h = fmaxf(bg_round(acc[j], bf16), 0.0f);
      acc[j] = h;
      sa[j * ld + t] = h;
#pragma unroll
      for (int k = 0; k < BG_OUT; ++k) o[k] = fmaf(h, w2[j * BG_OUT + k], o[k]);
    }
    float gh[BG_OUT];
#pragma unroll
    for (int k = 0; k < BG_OUT; ++k) {
      const float s = bg_sigmoid(bg_round(o[k], bf16));
      const float g = live ? g_rgb[n * BG_OUT + k] : 0.0f;
      gh[k] = bg_round(__fmul_rn(__fmul_rn(g, __fsub_rn(1.0f, s)), s), bf16);
      sg[k * ld + t] = gh[k];
    }
    // g_h1 = mask(h1) round(g_h W2^T), kept in acc
#pragma unroll
    for (int j = 0; j < BG_HID; ++j) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < BG_OUT; ++k) v = fmaf(gh[k], w2[j * BG_OUT + k], v);
      acc[j] = acc[j] > 0.0f ? bg_round(v, bf16) : 0.0f;
    }
    // g_x = round(g_h1 W1^T)[:L*F], level-major (scratch [L][N][F]), and
    // the ray's clipped sphere point after it ([N][2]), for bg_finish
    if (live) {
      scratch[(long long)LF * N + 2 * n] = xc[0];
      scratch[(long long)LF * N + 2 * n + 1] = xc[1];
      for (int i = 0; i < LF; ++i) {
        const float* wr = sw + i * BG_HID;
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < BG_HID; ++j) v = fmaf(acc[j], wr[j], v);
        scratch[((i / F) * N + n) * F + i % F] = bg_round(v, bf16);
      }
    }
    __syncthreads();
    // dW2 = h1^T g_h over the tile: thread j < 64 owns row j, its 3
    // entries' fmaf chains side by side (one load of h1[j][u] a ray)
    if (t < BG_HID) {
      const float* a = sa + t * ld;
      float acc3[BG_OUT] = {0.0f, 0.0f, 0.0f};
      for (int u = 0; u < rays; ++u) {
        const float au = a[u];
#pragma unroll
        for (int k = 0; k < BG_OUT; ++k) acc3[k] = fmaf(au, sg[k * ld + u], acc3[k]);
      }
#pragma unroll
      for (int k = 0; k < BG_OUT; ++k) {
        float* dst = part + NW1 + t * BG_OUT + k;
        *dst = first ? acc3[k] : __fadd_rn(*dst, acc3[k]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BG_HID; ++j) sa[j * ld + t] = acc[j];
    __syncthreads();
    // dW1 = x^T g_h1 over the tile: thread t owns column j = t % 64 of
    // rows i = t / 64 + s k (s = T / 64 threads a column), BG_KB rows at a
    // time: one load of g_h1[j][u] a ray for BG_KB fmaf chains
    {
      const int j = t % BG_HID, step = TT / BG_HID;
      const float* b = sa + j * ld;
      for (int i0 = t / BG_HID; i0 < IN; i0 += BG_KB * step) {
        float acc2[BG_KB];
#pragma unroll
        for (int k = 0; k < BG_KB; ++k) acc2[k] = 0.0f;
        for (int u = 0; u < rays; ++u) {
          const float bu = b[u];
#pragma unroll
          for (int k = 0; k < BG_KB; ++k) {
            const int i = i0 + k * step;
            if (i < IN) acc2[k] = fmaf(sx[i * ld + u], bu, acc2[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < BG_KB; ++k) {
          const int i = i0 + k * step;
          if (i < IN) {
            float* dst = part + i * BG_HID + j;
            *dst = first ? acc2[k] : __fadd_rn(*dst, acc2[k]);
          }
        }
      }
    }
    first = false;
    __syncthreads();  // X, A and G2 are the next tile's
  }
}

// bg_finish's table blocks: BG_FIN_T threads, the owners of
// BG_BLOCK_FLOATS / F rows of one level (each warp's copy of them
// BG_BLOCK_FLOATS floats); the rays staged BG_RAY_TILE at a time.  Of the
// shapes timed at 4096 rays, 16 warps a block read fastest (more warps
// splitting the rays), and __match_any_sync's groups beat a fixed xor
// butterfly (PERF.md).
#define BG_FIN_T 512
#define BG_BLOCK_FLOATS 1024
#define BG_FIN_WARPS (BG_FIN_T / 32)
#define BG_RAY_TILE 1024

// The second launch of the backward.  Blocks [0, n_wblocks): dW = the
// blocks' rows of partials summed in block order, rounded once to bf16 in
// bf16 mode (returned in fp32 for the fp32 master leaves).  The rest: the
// table's gradient, each row written once by the block that owns it (no
// atomics, no memset).  Per tile of rays staged in shared memory (two
// contiguous reads: the sphere points, the level's g_x), warp w takes the
// tile's chunks of 32 rays w, w + W, ... (W warps) in order and adds the
// corner contributions cw * g (rounded to bf16 under a bf16 gather) that
// fall in the block's rows, corner by corner, into its own copy of the
// rows' fp32 sums in shared memory: the lanes adding into one row are
// matched (__match_any_sync), summed into the lowest (reduce_peers:
// pairwise by rank) and added by it; then each row is the sum of the W
// copies in warp order.  So every row's sum has one fixed order, and a
// hot row (a coarse level's cell under many rays) costs one add a pass in
// each warp.
template <int F>
__global__ void __launch_bounds__(BG_FIN_T)
    bg_finish(const float* __restrict__ partials, int n_blocks, int nw, float* __restrict__ g_w,
              const float* __restrict__ scratch, float* __restrict__ g_table, long long N,
              HashLevels p, int bf16, int n_wblocks) {
  constexpr int R = BG_BLOCK_FLOATS / F;  // rows a block
  if ((int)blockIdx.x < n_wblocks) {
    const int e = blockIdx.x * BG_FIN_T + threadIdx.x;
    if (e >= nw) return;
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s = __fadd_rn(s, partials[(long long)b * nw + e]);
    g_w[e] = bg_round(s, bf16);
    return;
  }
  extern __shared__ float smem[];
  float* sacc = smem;                                 // [W][R][F]
  float* sxy = sacc + BG_FIN_WARPS * BG_BLOCK_FLOATS;  // [BG_RAY_TILE][2]
  float* sgv = sxy + 2 * BG_RAY_TILE;                 // [BG_RAY_TILE][F]
  const unsigned int level_rows = 1u << p.log2_size;
  const unsigned int per_level = (level_rows + R - 1) / R;
  const unsigned int q = blockIdx.x - n_wblocks;
  const int l = (int)(q / per_level);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the block's rows of level l: [r0, r0 + rows)
  const unsigned int r0 = (q % per_level) * R;
  const unsigned int rows = min((unsigned int)R, level_rows - r0);
  float* wacc = sacc + warp * BG_BLOCK_FLOATS;
  for (int i = threadIdx.x; i < BG_FIN_WARPS * BG_BLOCK_FLOATS; i += BG_FIN_T) sacc[i] = 0.0f;
  const unsigned int mask = level_rows - 1u;
  const float res = p.res[l];  // the block's level, read once
  const float* g_level = scratch + (long long)l * N * F;
  const float* xy = scratch + (long long)p.L * F * N;
  for (long long base = 0; base < N; base += BG_RAY_TILE) {
    const int rays = (int)min((long long)BG_RAY_TILE, N - base);
    __syncthreads();  // the zeros, or the previous tile's readers, are done
    for (int i = threadIdx.x; i < 2 * rays; i += BG_FIN_T) sxy[i] = xy[2 * base + i];
    for (int i = threadIdx.x; i < F * rays; i += BG_FIN_T) sgv[i] = g_level[F * base + i];
    __syncthreads();
    for (int c0 = warp * 32; c0 < rays; c0 += BG_FIN_T) {
      const int r = c0 + lane;
      const bool live = r < rays;
      float xc[2] = {0.0f, 0.0f}, g[F];
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = 0.0f;
      if (live) {
        xc[0] = sxy[2 * r];
        xc[1] = sxy[2 * r + 1];
#pragma unroll
        for (int f = 0; f < F; ++f) g[f] = sgv[F * r + f];
      }
      const Cell2d cell = cell_2d(xc, res);
#pragma unroll 1
      for (int k = 0; k < 4; ++k) {  // once in the code: nothing indexed by k
        unsigned int idx;
        float cw;
        corner_2d(cell, k, mask, 0u, idx, cw);
        const unsigned int row = idx - r0;  // wraps above 2^31 below r0
        float v[F];
        bool any = false;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          v[f] = bg_round(__fmul_rn(cw, g[f]), bf16);
          any = any || v[f] != 0.0f;
        }
        const bool hit = live && row < rows && any;
        const unsigned int adding = __ballot_sync(NGP_FULL, hit);
        if (adding != 0u) {
          unsigned int peers = 0u;
          if (hit) peers = __match_any_sync(adding, row);
          reduce_peers<F>(peers, lane, v);
          if (hit && (peers & ((1u << lane) - 1u)) == 0u) {
#pragma unroll
            for (int f = 0; f < F; ++f)
              wacc[row * F + f] = __fadd_rn(wacc[row * F + f], v[f]);
          }
          __syncwarp();  // this pass's adds before the next pass's
        }
      }
    }
  }
  __syncthreads();
  float* dst = g_table + ((unsigned long long)l * level_rows + r0) * F;
  for (unsigned int i = threadIdx.x; i < rows * F; i += BG_FIN_T) {
    float s = sacc[i];
#pragma unroll
    for (int w = 1; w < BG_FIN_WARPS; ++w) s = __fadd_rn(s, sacc[w * BG_BLOCK_FLOATS + i]);
    dst[i] = s;
  }
}

// Shared memory of each kernel, in bytes.
inline size_t bg_fwd_smem(int IN) {
  return sizeof(float) * (IN * BG_HID + BG_HID * BG_OUT);
}
inline size_t bg_bwd_smem(int IN, int tile) {
  return sizeof(float) * (IN * BG_HID + BG_HID * BG_OUT + (IN + BG_HID + BG_OUT) * (tile + 1));
}
inline size_t bg_finish_smem(int F) {
  return sizeof(float) * (BG_FIN_WARPS * BG_BLOCK_FLOATS + BG_RAY_TILE * (2 + F));
}

template <typename K>
static int bg_smem_attr(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int F>
int bg_launch_fwd(const BgInput& in, const void* table, const void* w, void* rgb,
                         long long N, const HashLevels& p, int bf16, cudaStream_t s) {
  const size_t smem = bg_fwd_smem(p.L * F + SH_DIM);
  const int rc = bg_smem_attr(bg_color_fwd<T, F>, smem);
  if (rc != 0) return rc;
  bg_color_fwd<T, F><<<ngp_blocks(N, BG_FWD_T), BG_FWD_T, smem, s>>>(
      in, (const T*)table, (const float*)w, (float*)rgb, N, p, bf16);
  NGP_RETURN_LAST_ERROR();
}

template <typename T, int F>
int bg_launch_bwd(const BgInput& in, const void* table, const void* w, const void* g_rgb,
                         void* scratch, void* partials, void* g_w, void* g_table, long long N,
                         const HashLevels& p, int bf16, int n_blocks, int tile, cudaStream_t s) {
  const int IN = p.L * F + SH_DIM, nw = IN * BG_HID + BG_HID * BG_OUT;
  const size_t smem = bg_bwd_smem(IN, tile);
  int rc = bg_smem_attr(bg_color_bwd<T, F>, smem);
  if (rc != 0) return rc;
  bg_color_bwd<T, F><<<n_blocks, tile, smem, s>>>(in, (const T*)table, (const float*)w,
                                                  (const float*)g_rgb, (float*)scratch,
                                                  (float*)partials, N, p, bf16);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t fsmem = bg_finish_smem(F);
  rc = bg_smem_attr(bg_finish<F>, fsmem);
  if (rc != 0) return rc;
  const int n_wblocks = (int)ngp_blocks(nw, BG_FIN_T);
  const int rows = BG_BLOCK_FLOATS / F;
  const int per_level = (int)(((1u << p.log2_size) + rows - 1) / rows);
  bg_finish<F><<<n_wblocks + p.L * per_level, BG_FIN_T, fsmem, s>>>(
      (const float*)partials, n_blocks, nw, (float*)g_w, (const float*)scratch,
      (float*)g_table, N, p, bf16, n_wblocks);
  NGP_RETURN_LAST_ERROR();
}

// background.cu is compiled once a row width (-DNGP_BG_F=1, 2, 4 or 8:
// that width's launchers, in parallel, ops/_cuda.py:SPLIT) and once for the
// C entry points, which call the launchers of every width.
#define BG_FWD_ARGS(T) const BgInput&, const void*, const void*, void*, long long,        \
                       const HashLevels&, int, cudaStream_t
#define BG_BWD_ARGS(T) const BgInput&, const void*, const void*, const void*, void*, void*, \
                       void*, void*, long long, const HashLevels&, int, int, int, cudaStream_t
#ifdef NGP_BG_F
template int bg_launch_fwd<float, NGP_BG_F>(BG_FWD_ARGS(float));
template int bg_launch_fwd<__nv_bfloat16, NGP_BG_F>(BG_FWD_ARGS(__nv_bfloat16));
template int bg_launch_bwd<float, NGP_BG_F>(BG_BWD_ARGS(float));
template int bg_launch_bwd<__nv_bfloat16, NGP_BG_F>(BG_BWD_ARGS(__nv_bfloat16));
#else
#define BG_EXTERN(FF)                                                           \
  extern template int bg_launch_fwd<float, FF>(BG_FWD_ARGS(float));             \
  extern template int bg_launch_fwd<__nv_bfloat16, FF>(BG_FWD_ARGS(__nv_bfloat16)); \
  extern template int bg_launch_bwd<float, FF>(BG_BWD_ARGS(float));             \
  extern template int bg_launch_bwd<__nv_bfloat16, FF>(BG_BWD_ARGS(__nv_bfloat16));
BG_EXTERN(1)
BG_EXTERN(2)
BG_EXTERN(4)
BG_EXTERN(8)
#undef BG_EXTERN

// rays_o, rays_d [N, 3] fp32; table [L << log2_size, F] in bf16 (bf16: the
// compute dtype's roundings too) or fp32; w the packed weights [IN * 64 +
// 64 * 3] fp32 (IN = L * F + 16); rgb [N, 3] fp32.
extern "C" int ngp_bg_color(const void* rays_o, const void* rays_d, float r2, const void* table,
                            int bf16, int F, const void* w, void* rgb, long long N, int L,
                            const float* res, int log2_size, void* stream) {
  HashLevels p;
  const int rc = bg_levels(p, L, res, log2_size);
  if (rc != 0) return rc;
  if (N == 0) return 0;
  const BgInput in{nullptr, (const float*)rays_o, (const float*)rays_d, r2};
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return bf16 ? bg_launch_fwd<__nv_bfloat16, 1>(in, table, w, rgb, N, p, 1, s)
                        : bg_launch_fwd<float, 1>(in, table, w, rgb, N, p, 0, s);
    case 2: return bf16 ? bg_launch_fwd<__nv_bfloat16, 2>(in, table, w, rgb, N, p, 1, s)
                        : bg_launch_fwd<float, 2>(in, table, w, rgb, N, p, 0, s);
    case 4: return bf16 ? bg_launch_fwd<__nv_bfloat16, 4>(in, table, w, rgb, N, p, 1, s)
                        : bg_launch_fwd<float, 4>(in, table, w, rgb, N, p, 0, s);
    case 8: return bf16 ? bg_launch_fwd<__nv_bfloat16, 8>(in, table, w, rgb, N, p, 1, s)
                        : bg_launch_fwd<float, 8>(in, table, w, rgb, N, p, 0, s);
  }
  return (int)cudaErrorInvalidValue;
}

// g_rgb [N, 3] fp32; scratch [N * (L * F + 2)] fp32, 16-byte aligned, and
// partials [n_blocks, NW] fp32 (NW = IN * 64 + 64 * 3), no initial values
// needed; g_w [NW] fp32;
// g_table [L << log2_size, F] fp32, every row written.  n_blocks blocks of
// ``tile`` rays (128, or 64 where bg_bwd_smem's staging would not fit),
// no more blocks than tiles.
extern "C" int ngp_bg_color_bwd(const void* rays_o, const void* rays_d, float r2,
                                const void* table, int bf16, int F, const void* w,
                                const void* g_rgb, void* scratch, void* partials, void* g_w,
                                void* g_table, long long N, int L, const float* res,
                                int log2_size, int n_blocks, int tile, void* stream) {
  HashLevels p;
  const int rc = bg_levels(p, L, res, log2_size);
  if (rc != 0) return rc;
  if (N < 1 || n_blocks < 1 || n_blocks > (N + tile - 1) / tile ||
      (tile != 64 && tile != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  const BgInput in{nullptr, (const float*)rays_o, (const float*)rays_d, r2};
  cudaStream_t s = (cudaStream_t)stream;
#define BG_BWD(TY, FF, B)                                                                   \
  bg_launch_bwd<TY, FF>(in, table, w, g_rgb, scratch, partials, g_w, g_table, N, p, B,     \
                        n_blocks, tile, s)
  switch (F) {
    case 1: return bf16 ? BG_BWD(__nv_bfloat16, 1, 1) : BG_BWD(float, 1, 0);
    case 2: return bf16 ? BG_BWD(__nv_bfloat16, 2, 1) : BG_BWD(float, 2, 0);
    case 4: return bf16 ? BG_BWD(__nv_bfloat16, 4, 1) : BG_BWD(float, 4, 0);
    case 8: return bf16 ? BG_BWD(__nv_bfloat16, 8, 1) : BG_BWD(float, 8, 0);
  }
#undef BG_BWD
  return (int)cudaErrorInvalidValue;
}
#endif  // NGP_BG_F
