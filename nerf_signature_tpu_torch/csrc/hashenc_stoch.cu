// K7: the stochastic hash estimators, F = 1, 2, 4 or 8 features a row.
//
// Replaces nerf_signature_tpu/ops/hashenc.py:_make_interp_stochastic (the
// custom VJP of the stochastic path) and the corner choice of
// _hash_encode_impl's stochastic branch.  Per (level l, sample m) one corner
// is drawn with probability equal to its trilinear weight, from the
// sample's own position bits: u = hash3(bits of x * res[l]) * 2^-24 (24
// bits of the XOR-of-primes hash), and the chosen corner is the first c (in
// the JAX corner order) with u < cw_0 + ... + cw_c, the sum in fp32 in that
// order, corner 7 when none qualifies (the rounded sum can fall short of
// 1).  The file is compiled with -fmad=false, so the choice is the plain
// version's bit for bit.
//
// hash_fwd_1c (--hash_fwd_corners 1): the features are the chosen corner's
// row, 1 * table_g[chosen], one row gathered per (level, sample) instead of
// eight.  K1's level-major tiling: a block takes 128 samples and every level
// (warp = level, lane = sample), stages the outputs in shared memory and
// writes rows of ``pitch`` floats, the columns past L*F zero (K4 reads its
// built input width).  Bound on the H100: bytes, the same as K1's forward
// but with one row read per (level, sample) instead of eight.
//
// hash_bwd_stoch (--stochastic_hash_grad, either forward): the gradient of
// the fp32 master table, the cotangent itself scattered into the chosen row
// -- not times the weight, and not rounded to bf16 even when the rows are
// gathered in bf16 (JAX's stochastic VJP casts the cotangent to the table's
// fp32 and no further).  With level_stride s > 1 a sample scatters only the
// levels l with l % s == phase, its cotangent times s; the phase is
// ((bits * 2654435761) >> 13) % s of a salted hash of the LAST level's
// scaled position (phase_bits = hash3(bits_x ^ 0x9E3779B9, bits_y, bits_z)
// & (2^24 - 1)).  Bound on the H100: bytes.  The kernel alone reads the
// cotangent once (a row of L*F floats a sample: a row's zeros are known
// only once read; or, counting only what the adds need, one F-float slice
// per kept live (level, sample)), a live sample's position, and the sectors
// of the zeroed gradient its atomics touch.  The whole call, the zeroing
// before the launch included, writes the table once (the touched sectors
// lie inside it) and reads the cotangent and the positions.  Design:
// * A block stages a tile of cotangent rows in shared memory (16-byte loads
//   where the pitch allows, a thread's loads issued NGP_STAGE_BATCH at a
//   time before their stores: hashenc.cuh:stage_g, K1's backward's
//   staging), marking each row that holds a nonzero value.
// * It compacts the tile's live rows once, in sample order (a ballot a
//   warp, the warps' counts summed), and for each live sample reads its
//   position and computes its level phase once.
// * Its warps then take tasks over the kept (level, live sample) pairs
//   only: task (slot j, 32 live samples), lane = live sample, at level j *
//   s + the sample's phase.  So every lane of a task adds (but where a live
//   row is zero at that level), and at stride s the corner work and the
//   adds are cut by s.
// * A lane draws its corner from the 8 weights and their running sum first
//   (chosen_row), then computes that one corner's row: one index hashed per
//   add, where the 8-corner path hashes eight.
// * K1's backward's adds: at a task holding a level at resolution <=
//   COMBINE_MAX_RES (ops/hashenc.py), the lanes adding into one row are
//   grouped by __match_any_sync and summed by reduce_peers (one atomic a
//   group; lanes at two levels never share a row but on the shared table,
//   where grouping them is right too); one vector atomic an add (float2 /
//   float4; two at F = 8).
// The atomics' order varies, so the result matches the plain version to
// fp32 rounding.  No gradient flows to the positions.

#include "hashenc.cuh"

// 24 bits of the XOR-of-primes hash of three uint32 words
__device__ __forceinline__ unsigned int hash24(unsigned int a, unsigned int b, unsigned int c) {
  return ((a * 1u) ^ (b * 2654435761u) ^ (c * 805459861u)) & 0xffffffu;
}

// The row of the corner drawn at this scaled position: the first corner c
// (JAX order) with u < cw_0 + ... + cw_c, the running sum in fp32 in that
// order, else corner 7; the weights first, then that one corner's row (one
// index hashed, not eight).
__device__ __forceinline__ unsigned int chosen_row(const float (&s)[3], unsigned int side,
                                                   unsigned int mask, unsigned int off) {
  const unsigned int ub = hash24(__float_as_uint(s[0]), __float_as_uint(s[1]),
                                 __float_as_uint(s[2]));
  const float u = __fmul_rn((float)ub, 5.9604644775390625e-8f);  // * 2^-24, exact
  float w[3];
  unsigned int cell[3];
  cell_of(s, cell, w);
  float cum = 0.0f;
  int chosen = 7;
  bool done = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    cum = __fadd_rn(cum, corner_weight(w, c));
    if (!done && u < cum) {
      chosen = c;
      done = true;
    }
  }
  return corner_row(cell, chosen, side, mask, off);
}

// A sample's level phase for level_stride s, from its clipped position and
// the last level's resolution
__device__ __forceinline__ unsigned int level_phase(const float (&xc)[3], float res_last,
                                                    unsigned int stride) {
  float s[3];
  scale(xc, res_last, s);
  const unsigned int pb = hash24(__float_as_uint(s[0]) ^ 0x9E3779B9u, __float_as_uint(s[1]),
                                 __float_as_uint(s[2]));
  return ((pb * 2654435761u) >> 13) % stride;
}

template <typename T, int F>
__global__ void __launch_bounds__(32 * NGP_ENC_WARPS)
    hash_fwd_1c(const float* __restrict__ x, const T* __restrict__ table,
                float* __restrict__ out, int pitch, int vec, long long M, HashLevels p) {
  extern __shared__ float smem[];
  const int LF = p.L * F, P = stage_pitch<F>(LF);
  float* sx = smem;                     // [TILE][3] clipped positions
  float* so = smem + 3 * NGP_ENC_TILE;  // [TILE][P] outputs
  const long long m0 = (long long)blockIdx.x * NGP_ENC_TILE;
  const int rows = (int)min((long long)NGP_ENC_TILE, M - m0);
  stage_x(sx, x, m0, rows);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned int mask = (1u << p.log2_size) - 1u;
  for (int l = warp; l < p.L; l += NGP_ENC_WARPS) {
    const float res = p.res[l];
    const unsigned int side = p.side[l], off = p.offset[l];
#pragma unroll
    for (int k = 0; k < NGP_ENC_TILE / 32; ++k) {
      const int s = k * 32 + lane;
      const int sc = min(s, rows - 1);  // lanes past the ragged end repeat a sample
      const float xc[3] = {sx[sc * 3 + 0], sx[sc * 3 + 1], sx[sc * 3 + 2]};
      float sp[3];
      scale(xc, res, sp);
      float r[F];
      load_row<F>(table, chosen_row(sp, side, mask, off), r);
      store_f<F>(so + s * P + l * F, r);
    }
  }
  __syncthreads();
  store_tile<F>(out, so, m0, rows, pitch, vec, LF, P);
}

// The backward's shared memory a sample: its staged cotangent row (P
// floats), its position (3) and its entry in the live list (1 word)
__host__ __device__ __forceinline__ int stoch_words(int P) { return P + 4; }

template <int F>
__global__ void __launch_bounds__(32 * NGP_ENC_WARPS)
    hash_bwd_stoch(const float* __restrict__ x, const float* __restrict__ g_feat, int pitch,
                   int vec, float* __restrict__ g_table, long long M, int tile, HashLevels p,
                   unsigned int combine, int stride) {
  extern __shared__ float smem[];
  __shared__ float sres[NGP_MAX_LEVELS];
  __shared__ unsigned int soff[NGP_MAX_LEVELS], sside[NGP_MAX_LEVELS];
  __shared__ int swarp[NGP_ENC_WARPS];
  const int LF = p.L * F, P = stage_pitch<F>(LF);
  float* sg = smem;            // [tile][P] cotangents
  float* sx = sg + tile * P;   // [tile][3] the live samples' clipped positions, in list order
  unsigned int* slist = reinterpret_cast<unsigned int*>(sx + 3 * tile);
  // slist: first each row's live flag, then the live list: row | phase << 16
  const long long m0 = (long long)blockIdx.x * tile;
  const int rows = (int)min((long long)tile, M - m0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) slist[i] = 0u;
  for (int l = threadIdx.x; l < p.L; l += blockDim.x) {
    sres[l] = p.res[l];
    soff[l] = p.offset[l];
    sside[l] = p.side[l];
  }
  __syncthreads();
  stage_g(sg, slist, g_feat, m0, rows, pitch, vec, LF, P);
  __syncthreads();

  // the live rows in sample order (tile <= the block's threads): thread t
  // lists row t, reads its position and computes its phase
  const int t = threadIdx.x;
  const bool live = t < rows && slist[t] != 0u;
  const unsigned int ballot = __ballot_sync(NGP_FULL, live);
  if (lane == 0) swarp[warp] = __popc(ballot);
  __syncthreads();  // every flag read: the list may overwrite them
  int n_live = 0, k = 0;
#pragma unroll
  for (int w = 0; w < NGP_ENC_WARPS; ++w) {
    if (w == warp) k = n_live;
    n_live += swarp[w];
  }
  if (live) {
    k += __popc(ballot & ((1u << lane) - 1u));
    float xc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xc[a] = ngp_clip(x[(m0 + t) * 3 + a], 0.0f, 1.0f);
      sx[3 * k + a] = xc[a];
    }
    const unsigned int phase =
        stride > 1 ? level_phase(xc, sres[p.L - 1], (unsigned int)stride) : 0u;
    slist[k] = (unsigned int)t | (phase << 16);
  }
  __syncthreads();

  const unsigned int mask = (1u << p.log2_size) - 1u;
  const float scale_ct = (float)stride;
  const int chunks = (n_live + 31) >> 5, tasks = (p.L / stride) * chunks;
  for (int task = warp; task < tasks; task += NGP_ENC_WARPS) {
    const int j = task / chunks, i = (task - j * chunks) * 32 + lane;
    const bool active = i < n_live;
    const int ic = active ? i : 0;
    const unsigned int e = slist[ic];
    const int s = (int)(e & 0xffffu), l = j * stride + (int)(e >> 16);
    float g[F];
    bool any = false;
    if (active) {
      load_f<F>(sg + s * P + l * F, g);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (stride > 1) g[f] = __fmul_rn(g[f], scale_ct);
        any = any || g[f] != 0.0f;
      }
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = 0.0f;
    }
    if (!__any_sync(NGP_FULL, any)) continue;  // 32 zero slices of live rows

    const float xc[3] = {sx[3 * ic], sx[3 * ic + 1], sx[3 * ic + 2]};
    float sp[3];
    scale(xc, sres[l], sp);
    const unsigned int row = chosen_row(sp, sside[l], mask, soff[l]);
    const bool grouped = __any_sync(NGP_FULL, any && ((combine >> l) & 1u));
    warp_add<F>(g_table, row, g, any, grouped, lane);
  }
}

template <typename T, int F>
static int launch_fwd_1c(const void* x, const void* table, void* out, int pitch, long long M,
                         const HashLevels& p, cudaStream_t s) {
  auto kernel = hash_fwd_1c<T, F>;
  const size_t smem = sizeof(float) * NGP_ENC_TILE * (3 + stage_pitch<F>(p.L * F));
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<ngp_blocks(M, NGP_ENC_TILE), 32 * NGP_ENC_WARPS, smem, s>>>(
      (const float*)x, (const T*)table, (float*)out, pitch, vec_width(out, pitch), M, p);
  NGP_RETURN_LAST_ERROR();
}

template <typename T>
static int dispatch_fwd_1c(int F, const void* x, const void* table, void* out, int pitch,
                           long long M, const HashLevels& p, cudaStream_t s) {
  switch (F) {
    case 1: return launch_fwd_1c<T, 1>(x, table, out, pitch, M, p, s);
    case 2: return launch_fwd_1c<T, 2>(x, table, out, pitch, M, p, s);
    case 4: return launch_fwd_1c<T, 4>(x, table, out, pitch, M, p, s);
    case 8: return launch_fwd_1c<T, 8>(x, table, out, pitch, M, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// table: [rows, F] in bf16 (table_bf16) or fp32; out [M, pitch] fp32 with
// pitch >= L*F (the columns past L*F written as zeros); levels: the
// geometry's level block (take_levels).
extern "C" int ngp_hash_encode_1c(const void* x, const void* table, int table_bf16, int F,
                                  void* out, int pitch, long long M, const HashLevels* levels,
                                  void* stream) {
  HashLevels p;
  const int rc = take_levels(p, levels);
  if (rc != 0) return rc;
  if (F != 1 && F != 2 && F != 4 && F != 8) return (int)cudaErrorInvalidValue;
  if (pitch < p.L * F) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return table_bf16 ? dispatch_fwd_1c<__nv_bfloat16>(F, x, table, out, pitch, M, p, s)
                    : dispatch_fwd_1c<float>(F, x, table, out, pitch, M, p, s);
}

template <int F>
static int launch_bwd_stoch(const void* x, const void* g_feat, int pitch, void* g_table,
                            long long M, const HashLevels& p, unsigned int combine, int stride,
                            int tile, cudaStream_t s) {
  // a thread lists each row of a tile; the shared memory fits beside the
  // static level arrays within the 48 KB a block has without opting in
  const size_t smem = sizeof(float) * tile * stoch_words(stage_pitch<F>(p.L * F));
  if (tile < 32 || tile % 32 != 0 || tile > 32 * NGP_ENC_WARPS || smem > 47 * 1024)
    return (int)cudaErrorInvalidValue;
  hash_bwd_stoch<F><<<ngp_blocks(M, tile), 32 * NGP_ENC_WARPS, smem, s>>>(
      (const float*)x, (const float*)g_feat, pitch, vec_width(g_feat, pitch), (float*)g_table, M,
      tile, p, combine, stride);
  NGP_RETURN_LAST_ERROR();
}

// g_feat: [M, pitch] fp32 with pitch >= L*F (the columns past L*F are not
// read); g_table: [rows, F] fp32, zeroed, 16-byte aligned.  stride: the
// effective level stride (1, or a divisor of L).  tile: the samples a block
// takes (ops/hashenc.py:stoch_bwd_tile), a multiple of 32 up to the block's
// threads whose shared memory fits 47 KB, else refused.
extern "C" int ngp_hash_encode_bwd_stoch(const void* x, const void* g_feat, int pitch, int F,
                                         void* g_table, long long M, const HashLevels* levels,
                                         unsigned int combine, int stride, int tile,
                                         void* stream) {
  HashLevels p;
  const int rc = take_levels(p, levels);
  if (rc != 0) return rc;
  if (pitch < p.L * F || stride < 1 || p.L % stride != 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1:
      return launch_bwd_stoch<1>(x, g_feat, pitch, g_table, M, p, combine, stride, tile, s);
    case 2:
      return launch_bwd_stoch<2>(x, g_feat, pitch, g_table, M, p, combine, stride, tile, s);
    case 4:
      return launch_bwd_stoch<4>(x, g_feat, pitch, g_table, M, p, combine, stride, tile, s);
    case 8:
      return launch_bwd_stoch<8>(x, g_feat, pitch, g_table, M, p, combine, stride, tile, s);
  }
  return (int)cudaErrorInvalidValue;
}

