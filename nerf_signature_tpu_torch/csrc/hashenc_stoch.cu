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
// & (2^24 - 1)).  K1's backward design otherwise: a staged tile, one warp a
// (level, 32 samples) task, an all-zero task skipped by a ballot, coarse
// levels' adds grouped by row (__match_any_sync, summed by reduce_peers, one
// atomic a group), one vector atomic per (level, sample) instead of K1's
// eight.  Bound: bytes (the cotangent read, the table's gradient written).
// The atomics' order varies, so the result matches the plain version to
// fp32 rounding.  No gradient flows to the positions.

#include "hashenc.cuh"

// 24 bits of the XOR-of-primes hash of three uint32 words
__device__ __forceinline__ unsigned int hash24(unsigned int a, unsigned int b, unsigned int c) {
  return ((a * 1u) ^ (b * 2654435761u) ^ (c * 805459861u)) & 0xffffffu;
}

// The row of the corner drawn at this scaled position (corners' rows and
// weights given): JAX's running sum, first corner with u < cum, else 7.
__device__ __forceinline__ unsigned int chosen_row(const float (&s)[3],
                                                   const unsigned int (&idx)[8],
                                                   const float (&cw)[8]) {
  const unsigned int ub = hash24(__float_as_uint(s[0]), __float_as_uint(s[1]),
                                 __float_as_uint(s[2]));
  const float u = __fmul_rn((float)ub, 5.9604644775390625e-8f);  // * 2^-24, exact
  float cum = 0.0f;
  unsigned int row = idx[7];
  bool done = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    cum = __fadd_rn(cum, cw[c]);
    if (!done && u < cum) {
      row = idx[c];
      done = true;
    }
  }
  return row;
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
      unsigned int idx[8];
      float cw[8];
      corners_of(sp, side, mask, off, idx, cw);
      float r[F];
      load_row<F>(table, chosen_row(sp, idx, cw), r);
      store_f<F>(so + s * P + l * F, r);
    }
  }
  __syncthreads();
  store_tile<F>(out, so, m0, rows, pitch, vec, LF, P);
}

template <int F>
__global__ void __launch_bounds__(32 * NGP_ENC_WARPS)
    hash_bwd_stoch(const float* __restrict__ x, const float* __restrict__ g_feat, int pitch,
                   int vec, float* __restrict__ g_table, long long M, int tile, HashLevels p,
                   unsigned int combine, int stride) {
  extern __shared__ float smem[];
  const int LF = p.L * F, P = stage_pitch<F>(LF);
  float* sx = smem;             // [tile][3] clipped positions
  float* sg = smem + 3 * tile;  // [tile][P] cotangents
  const long long m0 = (long long)blockIdx.x * tile;
  const int rows = (int)min((long long)tile, M - m0);
  stage_x(sx, x, m0, rows);
  stage_g(sg, g_feat, m0, rows, pitch, vec, LF, P);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned int mask = (1u << p.log2_size) - 1u;
  const float res_last = p.res[p.L - 1];
  const float scale_ct = (float)stride;
  const int groups = (rows + 31) >> 5;
  for (int t = warp; t < p.L * groups; t += NGP_ENC_WARPS) {
    const int l = t / groups, s = (t - l * groups) * 32 + lane;
    const int sc = s < rows ? s : 0;
    const float xc[3] = {sx[sc * 3 + 0], sx[sc * 3 + 1], sx[sc * 3 + 2]};
    float g[F];
    bool keep = s < rows;
    if (keep && stride > 1) keep = (unsigned int)l % (unsigned int)stride ==
                                   level_phase(xc, res_last, (unsigned int)stride);
    if (keep) {
      load_f<F>(sg + s * P + l * F, g);
      if (stride > 1) {
#pragma unroll
        for (int f = 0; f < F; ++f) g[f] = __fmul_rn(g[f], scale_ct);
      }
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = 0.0f;
    }
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) any = any || g[f] != 0.0f;
    if (!__any_sync(NGP_FULL, any)) continue;  // 32 zero cotangents

    float sp[3];
    scale(xc, p.res[l], sp);
    unsigned int idx[8];
    float cw[8];
    corners_of(sp, p.side[l], mask, p.offset[l], idx, cw);
    const bool grouped = (combine >> l) & 1u;  // the same for the whole warp
    warp_add<F>(g_table, chosen_row(sp, idx, cw), g, any, grouped, lane);
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
                            cudaStream_t s) {
  const int P = stage_pitch<F>(p.L * F), tile = bwd_tile(P);
  const size_t smem = sizeof(float) * tile * (3 + P);
  hash_bwd_stoch<F><<<ngp_blocks(M, tile), 32 * NGP_ENC_WARPS, smem, s>>>(
      (const float*)x, (const float*)g_feat, pitch, vec_width(g_feat, pitch), (float*)g_table, M,
      tile, p, combine, stride);
  NGP_RETURN_LAST_ERROR();
}

// g_feat: [M, pitch] fp32 with pitch >= L*F (the columns past L*F are not
// read); g_table: [rows, F] fp32, zeroed, 16-byte aligned.  stride: the
// effective level stride (1, or a divisor of L).
extern "C" int ngp_hash_encode_bwd_stoch(const void* x, const void* g_feat, int pitch, int F,
                                         void* g_table, long long M, const HashLevels* levels,
                                         unsigned int combine, int stride, void* stream) {
  HashLevels p;
  const int rc = take_levels(p, levels);
  if (rc != 0) return rc;
  if (pitch < p.L * F || stride < 1 || p.L % stride != 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch_bwd_stoch<1>(x, g_feat, pitch, g_table, M, p, combine, stride, s);
    case 2: return launch_bwd_stoch<2>(x, g_feat, pitch, g_table, M, p, combine, stride, s);
    case 4: return launch_bwd_stoch<4>(x, g_feat, pitch, g_table, M, p, combine, stride, s);
    case 8: return launch_bwd_stoch<8>(x, g_feat, pitch, g_table, M, p, combine, stride, s);
  }
  return (int)cudaErrorInvalidValue;
}
