// K1: multiresolution hash encoding, forward and backward, F = 1, 2, 4 or 8
// features a row.
//
// Forward: replaces nerf_signature_tpu/ops/hashenc.py:_hash_encode_impl (the
// exact 8-corner path) with _make_gather_rows' forward gather.  Backward
// (hash_encode_bwd, below): replaces _make_gather_rows' bwd, the fp32
// per-feature scatter-add into the master table.
//
// What bounds it on the H100: memory.  Per sample it reads 12 B of position
// and writes L*F*4 = 128 B of features (16 x 2 and 8 x 4); the 8 corner rows
// per level are random reads from the table.  The bf16 table copy at the
// default config is 16 levels * 2^19 rows * 4 B = 33.5 MB, which fits in the
// 50 MB L2, so after the first touches the gathers are L2 hits; the fp32
// master table (67 MB) would not fit, which is why the caller gathers from a
// bf16 copy cast once per render.  What the kernel pays beyond the bytes is
// L2 sectors: a gather instruction whose 32 lanes read 32 rows costs 32.
//
// Forward design, level-major: a block takes a tile of TILE consecutive
// samples and every level; warp w takes levels w, w + WARPS, ..., with lane
// = sample.  Neighbouring samples of a ray read the same corner rows at
// every level coarser than about one cell a step, and the zero-filled
// padded slots of a chunk all sit at one point, so one instruction's lanes
// share sectors there.  The tile's [TILE, L*F] fp32 outputs are staged in
// shared memory (row pitch stage_pitch(L*F) floats: the lanes' F-wide
// stores fall in distinct banks) and written out as 16-byte stores that
// cover the tile's contiguous output.  The output rows have a pitch of their
// own (``pitch`` >= L*F floats, the columns past L*F written as zeros): K4
// reads the features at its built input width, so an encoding width that K4
// lacks (24, 48, ...) reaches it zero-padded with no copy.  Level parameters
// (res, offset, dense side) are per warp.  A corner row is one load: F = 1 a
// 2-byte (bf16) or 4-byte (fp32) load, F = 2 a 4- or 8-byte one, F = 4 an 8-
// or 16-byte one, F = 8 one 16-byte load (bf16) or two (fp32).  The corner
// hash is uint32 arithmetic that wraps exactly like the JAX version; dense
// levels use the row-major index.  The file is compiled with -fmad=false and
// every product and sum is written out in the JAX order (corner 0 first,
// weights as (wx|1-wx)*(wy|1-wy)*(wz|1-wz)), so the kernel rounds exactly
// where the plain version does.

#include "hashenc.cuh"

template <typename T, int F>
__global__ void __launch_bounds__(32 * NGP_ENC_WARPS)
    hash_encode_fwd(const float* __restrict__ x, const T* __restrict__ table,
                    float* __restrict__ out, int pitch, int vec, long long M, HashLevels p) {
  extern __shared__ float smem[];
  const int LF = p.L * F, P = stage_pitch<F>(LF);
  float* sx = smem;                        // [TILE][3] clipped positions
  float* so = smem + 3 * NGP_ENC_TILE;     // [TILE][P] outputs
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
      unsigned int idx[8];
      float cw[8];
      corners(xc, res, side, mask, off, idx, cw);
      float acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float r[F];
        load_row<F>(table, idx[c], r);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(cw[c], r[f]));
      }
      store_f<F>(so + s * P + l * F, acc);
    }
  }
  __syncthreads();
  store_tile<F>(out, so, m0, rows, pitch, vec, LF, P);
}

// K1 backward: the gradient of the fp32 master table [rows, F] from the
// feature cotangent [M, pitch] (its first L*F columns).
//
// What bounds it on the H100: bytes.  It reads the whole cotangent (4 L F B
// a sample, most of it zeros: padded and dead samples) and 12 B of position
// for each sample with a nonzero one, and the wrapper zero-fills the
// gradient table (67 MB at 16 x 2^19 x 2, which does not fit the 50 MB L2).
// What it pays beyond the bytes is the scatter: 8 corners x (sample, level)
// of atomic adds, and at coarse levels the samples of a ray pile onto a few
// rows, whose adds serialise at the L2's atomic units.
//
// Design, level-major like the forward: a block takes a tile of consecutive
// samples and stages their clipped positions and cotangent rows in shared
// memory (the cotangent with streamed 16-byte loads over the tile's contiguous
// rows, NGP_STAGE_BATCH a thread in flight, the padded columns past L*F
// skipped: stage_g, which K7's backward shares).  A warp takes one (level,
// group of 32 samples) task at a time, lane = sample; tasks run level-major
// over the block's 8 warps, so a one-level table (the message feature) still
// fills them.  A task whose 32 cotangents are all zero is skipped by a ballot:
// the dead slots at a ray's end and the padded samples cost a shared-memory
// read.  Each lane recomputes its 8 corner rows and weights with the forward's
// exact arithmetic (corners()), and per corner its contribution cw_c * g
// (rounded to bf16 on its own under a bf16 gather, as JAX's bf16 row gather's
// cotangent is).  At levels whose bit is set in ``combine`` (coarse ones,
// chosen on the host from the resolution), __match_any_sync groups the lanes
// that add into one row and the group's lowest lane sums its peers'
// contributions by a tree of shuffles (pairwise by rank within the group,
// reduce_peers) and issues one atomic for the group; elsewhere every lane adds
// its own.  An add is one vector atomic a corner (sm_90's float2 / float4
// atomicAdd in global memory; two float4 at F = 8), fire-and-forget (RED).  A
// zero contribution is not added: adding +-0 to the zero-filled fp32 sum never
// changes it.  No gradient flows to the positions.  The order of the adds
// varies from run to run, so the result matches the plain version to fp32
// rounding, not bit for bit.
template <int F>
__global__ void __launch_bounds__(32 * NGP_ENC_WARPS)
    hash_encode_bwd(const float* __restrict__ x, const float* __restrict__ g_feat, int pitch,
                    int vec, float* __restrict__ g_table, long long M, int tile, HashLevels p,
                    int round_bf16, unsigned int combine) {
  extern __shared__ float smem[];
  const int LF = p.L * F, P = stage_pitch<F>(LF);
  float* sx = smem;             // [tile][3] clipped positions
  float* sg = smem + 3 * tile;  // [tile][P] cotangents
  const long long m0 = (long long)blockIdx.x * tile;
  const int rows = (int)min((long long)tile, M - m0);
  stage_x(sx, x, m0, rows);
  stage_g(sg, nullptr, g_feat, m0, rows, pitch, vec, LF, P);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned int mask = (1u << p.log2_size) - 1u;
  const int groups = (rows + 31) >> 5;
  for (int t = warp; t < p.L * groups; t += NGP_ENC_WARPS) {
    const int l = t / groups, s = (t - l * groups) * 32 + lane;
    float g[F];
    if (s < rows) {
      load_f<F>(sg + s * P + l * F, g);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = 0.0f;
    }
    bool hot = false;
#pragma unroll
    for (int f = 0; f < F; ++f) hot = hot || g[f] != 0.0f;
    if (!__any_sync(NGP_FULL, hot)) continue;  // 32 zero cotangents

    const int sc = s < rows ? s : 0;
    const float xc[3] = {sx[sc * 3 + 0], sx[sc * 3 + 1], sx[sc * 3 + 2]};
    unsigned int idx[8];
    float cw[8];
    corners(xc, p.res[l], p.side[l], mask, p.offset[l], idx, cw);
    const bool grouped = (combine >> l) & 1u;  // the same for the whole warp
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v[F];
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v[f] = __fmul_rn(cw[c], g[f]);
        if (round_bf16) v[f] = __bfloat162float(__float2bfloat16_rn(v[f]));
        any = any || v[f] != 0.0f;
      }
      warp_add<F>(g_table, idx[c], v, any, grouped, lane);
    }
  }
}

template <typename T, int F>
static int launch_fwd(const void* x, const void* table, void* out, int pitch, long long M,
                      const HashLevels& p, cudaStream_t s) {
  auto kernel = hash_encode_fwd<T, F>;
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
static int dispatch_fwd(int F, const void* x, const void* table, void* out, int pitch,
                        long long M, const HashLevels& p, cudaStream_t s) {
  switch (F) {
    case 1: return launch_fwd<T, 1>(x, table, out, pitch, M, p, s);
    case 2: return launch_fwd<T, 2>(x, table, out, pitch, M, p, s);
    case 4: return launch_fwd<T, 4>(x, table, out, pitch, M, p, s);
    case 8: return launch_fwd<T, 8>(x, table, out, pitch, M, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// table: [rows, F] in bf16 (table_bf16) or fp32, F = 1, 2, 4 or 8; out
// [M, pitch] fp32 with pitch >= L*F (the columns past L*F written as zeros).
// levels: the geometry's level block (take_levels).
extern "C" int ngp_hash_encode(const void* x, const void* table, int table_bf16, int F,
                               void* out, int pitch, long long M, const HashLevels* levels,
                               void* stream) {
  HashLevels p;
  const int rc = take_levels(p, levels);
  if (rc != 0) return rc;
  if (F != 1 && F != 2 && F != 4 && F != 8) return (int)cudaErrorInvalidValue;
  if (pitch < p.L * F) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return table_bf16 ? dispatch_fwd<__nv_bfloat16>(F, x, table, out, pitch, M, p, s)
                    : dispatch_fwd<float>(F, x, table, out, pitch, M, p, s);
}

template <int F>
static int launch_bwd(const void* x, const void* g_feat, int pitch, void* g_table, long long M,
                      const HashLevels& p, int round_bf16, unsigned int combine,
                      cudaStream_t s) {
  const int tile = bwd_tile(stage_pitch<F>(p.L * F));
  const size_t smem = sizeof(float) * tile * (3 + stage_pitch<F>(p.L * F));
  hash_encode_bwd<F><<<ngp_blocks(M, tile), 32 * NGP_ENC_WARPS, smem, s>>>(
      (const float*)x, (const float*)g_feat, pitch, vec_width(g_feat, pitch), (float*)g_table, M,
      tile, p, round_bf16, combine);
  NGP_RETURN_LAST_ERROR();
}

// g_feat: [M, pitch] fp32 with pitch >= L*F (the columns past L*F are not
// read); g_table: [rows, F] fp32, zeroed, 16-byte aligned.  combine: bit l
// set where level l's adds are grouped by row before the atomics.
extern "C" int ngp_hash_encode_bwd(const void* x, const void* g_feat, int pitch, int round_bf16,
                                   int F, void* g_table, long long M, const HashLevels* levels,
                                   unsigned int combine, void* stream) {
  HashLevels p;
  const int rc = take_levels(p, levels);
  if (rc != 0) return rc;
  if (pitch < p.L * F) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch_bwd<1>(x, g_feat, pitch, g_table, M, p, round_bf16, combine, s);
    case 2: return launch_bwd<2>(x, g_feat, pitch, g_table, M, p, round_bf16, combine, s);
    case 4: return launch_bwd<4>(x, g_feat, pitch, g_table, M, p, round_bf16, combine, s);
    case 8: return launch_bwd<8>(x, g_feat, pitch, g_table, M, p, round_bf16, combine, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ngp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
