// K1: multiresolution hash encoding, forward and backward, F = 2 or 4
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
// shared memory (row pitch L*F + F floats: the lanes' F-wide stores fall in
// distinct banks) and written out as 16-byte stores that cover the tile's
// contiguous output.  Level parameters (res, offset, dense side) are per
// warp.  A corner row is one load: F = 2 a 4-byte (bf16) or 8-byte (fp32)
// load, F = 4 an 8-byte or 16-byte one.  The corner hash is uint32
// arithmetic that wraps exactly like the JAX version; dense levels use the
// row-major index.  The file is compiled with -fmad=false and every product
// and sum is written out in the JAX order (corner 0 first, weights as
// (wx|1-wx)*(wy|1-wy)*(wz|1-wz)), so the kernel rounds exactly where the
// plain version does.

#include <cuda_bf16.h>

#include "common.cuh"

#define NGP_MAX_LEVELS 32
#define NGP_ENC_TILE 128
#define NGP_ENC_WARPS 8

struct HashLevels {
  int L;
  int log2_size;
  float res[NGP_MAX_LEVELS];
  unsigned int offset[NGP_MAX_LEVELS];
  unsigned int side[NGP_MAX_LEVELS];  // 0 = hashed level
};

template <int F>
__device__ __forceinline__ void load_row(const __nv_bfloat16* table, unsigned int row,
                                         float (&r)[F]) {
  if constexpr (F == 2) {
    const float2 v = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(table)[row]);
    r[0] = v.x;
    r[1] = v.y;
  } else {
    static_assert(F == 4, "rows of 2 or 4 features");
    const uint2 u = reinterpret_cast<const uint2*>(table)[row];
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    r[0] = lo.x;
    r[1] = lo.y;
    r[2] = hi.x;
    r[3] = hi.y;
  }
}

template <int F>
__device__ __forceinline__ void load_row(const float* table, unsigned int row, float (&r)[F]) {
  if constexpr (F == 2) {
    const float2 v = reinterpret_cast<const float2*>(table)[row];
    r[0] = v.x;
    r[1] = v.y;
  } else {
    static_assert(F == 4, "rows of 2 or 4 features");
    const float4 v = reinterpret_cast<const float4*>(table)[row];
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  }
}

// The 8 corners of one (sample, level): rows (level offset added) and
// trilinear weights, in the JAX corner order and with its roundings.
__device__ __forceinline__ void corners(const float (&xc)[3], float res, unsigned int side,
                                        unsigned int mask, unsigned int off,
                                        unsigned int (&idx)[8], float (&cw)[8]) {
  float w[3];
  unsigned int cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __fmul_rn(xc[a], res);
    const float f = floorf(s);
    w[a] = __fsub_rn(s, f);
    cell[a] = (unsigned int)f;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned int di = (c >> 2) & 1u, dj = (c >> 1) & 1u, dk = c & 1u;
    const unsigned int cx = cell[0] + di, cy = cell[1] + dj, cz = cell[2] + dk;
    if (side) {
      idx[c] = (cx * side + cy) * side + cz + off;
    } else {
      idx[c] = (((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) & mask) + off;
    }
    const float wx = di ? w[0] : __fsub_rn(1.0f, w[0]);
    const float wy = dj ? w[1] : __fsub_rn(1.0f, w[1]);
    const float wz = dk ? w[2] : __fsub_rn(1.0f, w[2]);
    cw[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(32 * NGP_ENC_WARPS)
    hash_encode_fwd(const float* __restrict__ x, const T* __restrict__ table,
                    float* __restrict__ out, long long M, HashLevels p) {
  extern __shared__ float smem[];
  const int LF = p.L * F, P = LF + F;
  float* sx = smem;                        // [TILE][3] clipped positions
  float* so = smem + 3 * NGP_ENC_TILE;     // [TILE][P] outputs
  const long long m0 = (long long)blockIdx.x * NGP_ENC_TILE;
  const int rows = (int)min((long long)NGP_ENC_TILE, M - m0);
  for (int i = threadIdx.x; i < 3 * rows; i += blockDim.x)
    sx[i] = ngp_clip(x[m0 * 3 + i], 0.0f, 1.0f);
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
      float* dst = so + s * P + l * F;
      if constexpr (F == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
  }
  __syncthreads();

  // the tile's outputs are rows * LF contiguous floats of out
  float* dst = out + m0 * LF;
  if (LF % 4 == 0) {
    for (int i = threadIdx.x; i < rows * LF / 4; i += blockDim.x) {
      const int e = 4 * i, s = e / LF, c = e - s * LF;
      const float2 a = *reinterpret_cast<const float2*>(so + s * P + c);
      const float2 b = *reinterpret_cast<const float2*>(so + s * P + c + 2);
      reinterpret_cast<float4*>(dst)[i] = make_float4(a.x, a.y, b.x, b.y);
    }
  } else {  // F = 2 with an odd L: 8-byte stores
    for (int i = threadIdx.x; i < rows * LF / 2; i += blockDim.x) {
      const int e = 2 * i, s = e / LF, c = e - s * LF;
      reinterpret_cast<float2*>(dst)[i] = *reinterpret_cast<const float2*>(so + s * P + c);
    }
  }
}

// K1 backward: the gradient of the fp32 master table [rows, F] from the
// feature cotangent [M, L*F].
//
// What bounds it on the H100: the scatter.  Per (sample, level) it reads
// 12 B of position and 4F B of cotangent and makes 8 corners x F features of
// fp32 atomic adds into the 67 MB gradient table (which does not fit the 50
// MB L2); coarse levels pile many samples onto few rows, so their adds
// serialise at the L2 atomic units.
//
// Design: one thread per (sample, level), level-minor.  It recomputes the 8
// corner rows and weights with the forward's exact arithmetic (corners():
// same hash, dense index and level offset), and adds cw_c * g into a table
// the wrapper has zeroed: F = 2 with one atomicAdd a feature (fire-and-forget
// RED instructions), F = 4 with one float4 atomicAdd a corner (sm_90's
// vector atomic in global memory).  No gradient flows to the positions.
// Rounding: in JAX the gathered rows are bf16 under -O, so the product
// cws[c] * gather_rows(...) is bf16 x fp32 and the cotangent reaching
// _make_gather_rows' bwd is cw_c * g ROUNDED TO BF16, upcast to fp32 before
// the scatter (hashenc.py:125).  With round_bf16 the kernel rounds there;
// with an fp32 gather it does not round.  A zero contribution is skipped:
// adding +-0 to the zero-initialised fp32 sum never changes it, and padded
// samples carry a zero cotangent.  The order of the atomic adds varies from
// run to run, so the result matches the plain version to fp32 rounding, not
// bit for bit.
template <int F>
__global__ void hash_encode_bwd(const float* __restrict__ x, const float* __restrict__ g_feat,
                                float* __restrict__ g_table, long long M, HashLevels p,
                                int round_bf16) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= M * p.L) return;
  long long m = tid / p.L;
  int l = (int)(tid - m * p.L);
  float g[F];
  bool zero = true;
  if constexpr (F == 2) {
    const float2 v = reinterpret_cast<const float2*>(g_feat)[m * p.L + l];
    g[0] = v.x;
    g[1] = v.y;
  } else {
    const float4 v = reinterpret_cast<const float4*>(g_feat)[m * p.L + l];
    g[0] = v.x;
    g[1] = v.y;
    g[2] = v.z;
    g[3] = v.w;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) zero = zero && g[f] == 0.0f;
  if (zero) return;

  const float xc[3] = {ngp_clip(x[m * 3 + 0], 0.0f, 1.0f), ngp_clip(x[m * 3 + 1], 0.0f, 1.0f),
                       ngp_clip(x[m * 3 + 2], 0.0f, 1.0f)};
  unsigned int idx[8];
  float cw[8];
  corners(xc, p.res[l], p.side[l], (1u << p.log2_size) - 1u, p.offset[l], idx, cw);
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
    float* row = g_table + (unsigned long long)F * idx[c];
    if constexpr (F == 4) {
      if (any) atomicAdd(reinterpret_cast<float4*>(row), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f)
        if (v[f] != 0.0f) atomicAdd(row + f, v[f]);
    }
  }
}

static int fill_levels(HashLevels& p, int L, const float* res, const unsigned int* offset,
                       const unsigned int* side, int log2_size) {
  if (L < 1 || L > NGP_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  p.L = L;
  p.log2_size = log2_size;
  for (int l = 0; l < L; ++l) {
    p.res[l] = res[l];
    p.offset[l] = offset[l];
    p.side[l] = side[l];
  }
  return 0;
}

template <typename T, int F>
static int launch_fwd(const void* x, const void* table, void* out, long long M,
                      const HashLevels& p, cudaStream_t s) {
  auto kernel = hash_encode_fwd<T, F>;
  const size_t smem = sizeof(float) * NGP_ENC_TILE * (3 + p.L * F + F);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<ngp_blocks(M, NGP_ENC_TILE), 32 * NGP_ENC_WARPS, smem, s>>>(
      (const float*)x, (const T*)table, (float*)out, M, p);
  NGP_RETURN_LAST_ERROR();
}

// table: [rows, F] in bf16 (table_bf16) or fp32, F = 2 or 4; out [M, L*F]
// fp32, 16-byte aligned.
extern "C" int ngp_hash_encode(const void* x, const void* table, int table_bf16, int F,
                               void* out, long long M, int L, const float* res,
                               const unsigned int* offset, const unsigned int* side,
                               int log2_size, void* stream) {
  HashLevels p;
  const int rc = fill_levels(p, L, res, offset, side, log2_size);
  if (rc != 0) return rc;
  if (F != 2 && F != 4) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bf16)
    return F == 2 ? launch_fwd<__nv_bfloat16, 2>(x, table, out, M, p, s)
                  : launch_fwd<__nv_bfloat16, 4>(x, table, out, M, p, s);
  return F == 2 ? launch_fwd<float, 2>(x, table, out, M, p, s)
                : launch_fwd<float, 4>(x, table, out, M, p, s);
}

// g_table: [rows, F] fp32, zeroed, 16-byte aligned.
extern "C" int ngp_hash_encode_bwd(const void* x, const void* g_feat, int round_bf16, int F,
                                   void* g_table, long long M, int L, const float* res,
                                   const unsigned int* offset, const unsigned int* side,
                                   int log2_size, void* stream) {
  HashLevels p;
  const int rc = fill_levels(p, L, res, offset, side, log2_size);
  if (rc != 0) return rc;
  if (F != 2 && F != 4) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = ngp_blocks(M * L, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (F == 2)
    hash_encode_bwd<2><<<blocks, threads, 0, s>>>((const float*)x, (const float*)g_feat,
                                                  (float*)g_table, M, p, round_bf16);
  else
    hash_encode_bwd<4><<<blocks, threads, 0, s>>>((const float*)x, (const float*)g_feat,
                                                  (float*)g_table, M, p, round_bf16);
  NGP_RETURN_LAST_ERROR();
}

extern "C" const char* ngp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
