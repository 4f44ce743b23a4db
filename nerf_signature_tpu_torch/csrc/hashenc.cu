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

#include <cuda_bf16.h>

#include "common.cuh"

#define NGP_MAX_LEVELS 32
#define NGP_ENC_TILE 128
#define NGP_ENC_WARPS 8
#define NGP_BWD_TILE 256
#define NGP_FULL 0xffffffffu

struct HashLevels {
  int L;
  int log2_size;
  float res[NGP_MAX_LEVELS];
  unsigned int offset[NGP_MAX_LEVELS];
  unsigned int side[NGP_MAX_LEVELS];  // 0 = hashed level
};

__device__ __forceinline__ float2 bf2(unsigned int u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

template <int F>
__device__ __forceinline__ void load_row(const __nv_bfloat16* table, unsigned int row,
                                         float (&r)[F]) {
  static_assert(F == 1 || F == 2 || F == 4 || F == 8, "rows of 1, 2, 4 or 8 features");
  if constexpr (F == 1) {
    r[0] = __bfloat162float(table[row]);
  } else if constexpr (F == 2) {
    const float2 v = bf2(reinterpret_cast<const unsigned int*>(table)[row]);
    r[0] = v.x;
    r[1] = v.y;
  } else if constexpr (F == 4) {
    const uint2 u = reinterpret_cast<const uint2*>(table)[row];
    const float2 lo = bf2(u.x), hi = bf2(u.y);
    r[0] = lo.x;
    r[1] = lo.y;
    r[2] = hi.x;
    r[3] = hi.y;
  } else {
    const uint4 u = reinterpret_cast<const uint4*>(table)[row];
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = bf2(w[q]);
      r[2 * q] = v.x;
      r[2 * q + 1] = v.y;
    }
  }
}

template <int F>
__device__ __forceinline__ void load_row(const float* table, unsigned int row, float (&r)[F]) {
  static_assert(F == 1 || F == 2 || F == 4 || F == 8, "rows of 1, 2, 4 or 8 features");
  if constexpr (F == 1) {
    r[0] = table[row];
  } else if constexpr (F == 2) {
    const float2 v = reinterpret_cast<const float2*>(table)[row];
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 v =
          reinterpret_cast<const float4*>(table)[(unsigned long long)row * (F / 4) + q];
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  }
}

// F floats at p (shared memory, aligned to the access: stage_pitch keeps it)
template <int F>
__device__ __forceinline__ void store_f(float* p, const float (&v)[F]) {
  if constexpr (F == 1) {
    p[0] = v[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

template <int F>
__device__ __forceinline__ void load_f(const float* p, float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = p[0];
  } else if constexpr (F == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
}

// Row pitch (floats) of a tile of [L*F] rows staged in shared memory: the
// F-wide accesses of a warp's 32 lanes (one sample each) fall in distinct
// banks, one phase at a time.  F = 1: an odd pitch; F = 2 and 4: L*F + F;
// F = 8 (two 16-byte accesses a lane, 8 lanes a phase): L*F + 4, 4 mod 8.
template <int F>
__host__ __device__ __forceinline__ int stage_pitch(int LF) {
  return F == 1 ? (LF | 1) : F == 8 ? LF + 4 : LF + F;
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
                    float* __restrict__ out, int pitch, int vec, long long M, HashLevels p) {
  extern __shared__ float smem[];
  const int LF = p.L * F, P = stage_pitch<F>(LF);
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
      store_f<F>(so + s * P + l * F, acc);
    }
  }
  __syncthreads();

  // the tile's outputs are rows * pitch contiguous floats of out, written
  // vec floats a store (16-byte stores when the pitch allows); the columns
  // past L*F are zeros
  float* dst = out + m0 * pitch;
  const int n = rows * pitch / vec;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int e = vec * i, s = e / pitch, c = e - s * pitch;
    const float* src = so + s * P + c;
    float v[4];
    if (F >= 2 && vec == 4 && c + 4 <= LF) {  // P and c even: two 8-byte loads
      const float2 a = reinterpret_cast<const float2*>(src)[0];
      const float2 b = reinterpret_cast<const float2*>(src)[1];
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = (q < vec && c + q < LF) ? src[q] : 0.0f;
    }
    if (vec == 4) {
      reinterpret_cast<float4*>(dst)[i] = make_float4(v[0], v[1], v[2], v[3]);
    } else if (vec == 2) {
      reinterpret_cast<float2*>(dst)[i] = make_float2(v[0], v[1]);
    } else {
      dst[i] = v[0];
    }
  }
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
// memory (the cotangent with 16-byte loads over the tile's contiguous rows,
// the padded columns past L*F skipped).  A warp takes one (level, group of
// 32 samples) task at a time, lane = sample; tasks run level-major over the
// block's 8 warps, so a one-level table (the message feature) still fills
// them.  A task whose 32 cotangents are all zero is skipped by a ballot:
// the dead slots at a ray's end and the padded samples cost a shared-memory
// read.  Each lane recomputes its 8 corner rows and weights with the
// forward's exact arithmetic (corners()), and per corner its contribution
// cw_c * g (rounded to bf16 on its own under a bf16 gather, as JAX's
// bf16 row gather's cotangent is).  At levels whose bit is set in
// ``combine`` (coarse ones, chosen on the host from the resolution),
// __match_any_sync groups the lanes that add into one row and the group's
// lowest lane sums its peers' contributions by a tree of shuffles (pairwise
// by rank within the group, reduce_peers) and issues one atomic for the
// group; elsewhere every lane adds its own.  An add is one vector atomic a
// corner (sm_90's float2 / float4 atomicAdd in global memory; two float4 at
// F = 8), fire-and-forget (RED).  A zero contribution is not added: adding
// +-0 to the zero-filled fp32 sum never changes it.  No gradient flows to
// the positions.  The order of the adds varies from run to run, so the
// result matches the plain version to fp32 rounding, not bit for bit.
template <int F>
__device__ __forceinline__ void add_row(float* g_table, unsigned int row, const float (&v)[F]) {
  float* dst = g_table + (unsigned long long)F * row;
  if constexpr (F == 1) {
    atomicAdd(dst, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(dst) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  }
}

// Sum v over each group of ``peers`` (the lanes adding into one row, this
// lane included; 0 for a lane that adds nothing) into the group's lowest
// lane: each round, every lane still in the tree adds the value of the next
// one above it in its group, then the lanes at odd ranks leave.  So the sum
// is pairwise by rank, ((v0 + v1) + (v2 + v3)) + v4.  Every lane of the warp
// takes part.
template <int F>
__device__ __forceinline__ void reduce_peers(unsigned int peers, int lane, float (&v)[F]) {
  unsigned int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // the peers above this lane
  while (__any_sync(NGP_FULL, peers != 0u)) {
    const int next = __ffs(peers);  // 1 + the next peer above still in the tree, or 0
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float t = __shfl_sync(NGP_FULL, v[f], (next - 1) & 31);
      if (next) v[f] = __fadd_rn(v[f], t);
    }
    peers &= ~__ballot_sync(NGP_FULL, rank & 1u);
    rank >>= 1;
  }
}

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
  for (int i = threadIdx.x; i < 3 * rows; i += blockDim.x)
    sx[i] = ngp_clip(x[m0 * 3 + i], 0.0f, 1.0f);
  // the tile's cotangents: rows * pitch contiguous floats, vec a load
  const float* src = g_feat + m0 * pitch;
  const int n = rows * pitch / vec;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int e = vec * i, s = e / pitch, c = e - s * pitch;
    if (c >= LF) continue;  // the padded columns
    float v[4];
    if (vec == 4) {
      const float4 a = reinterpret_cast<const float4*>(src)[i];
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else if (vec == 2) {
      const float2 a = reinterpret_cast<const float2*>(src)[i];
      v[0] = a.x, v[1] = a.y;
    } else {
      v[0] = src[i];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < vec && c + q < LF) sg[s * P + c + q] = v[q];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned int mask = (1u << p.log2_size) - 1u;
  const unsigned int below = (1u << lane) - 1u;
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
      if (grouped) {
        const unsigned int adding = __ballot_sync(NGP_FULL, any);
        if (adding == 0u) continue;
        unsigned int peers = 0u;
        if (any) peers = __match_any_sync(adding, idx[c]);
        reduce_peers<F>(peers, lane, v);
        if (any && (peers & below) == 0u) add_row<F>(g_table, idx[c], v);
      } else if (any) {
        add_row<F>(g_table, idx[c], v);
      }
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

// floats a vector access to rows of ``pitch`` floats at ptr: 4 (16-byte
// accesses) where the pitch and the pointer allow it, else 2, else 1
static int vec_width(const void* ptr, int pitch) {
  const unsigned long long a = (unsigned long long)ptr;
  if (pitch % 4 == 0 && a % 16 == 0) return 4;
  if (pitch % 2 == 0 && a % 8 == 0) return 2;
  return 1;
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
extern "C" int ngp_hash_encode(const void* x, const void* table, int table_bf16, int F,
                               void* out, int pitch, long long M, int L, const float* res,
                               const unsigned int* offset, const unsigned int* side,
                               int log2_size, void* stream) {
  HashLevels p;
  const int rc = fill_levels(p, L, res, offset, side, log2_size);
  if (rc != 0) return rc;
  if (F != 1 && F != 2 && F != 4 && F != 8) return (int)cudaErrorInvalidValue;
  if (pitch < L * F) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return table_bf16 ? dispatch_fwd<__nv_bfloat16>(F, x, table, out, pitch, M, p, s)
                    : dispatch_fwd<float>(F, x, table, out, pitch, M, p, s);
}

template <int F>
static int launch_bwd(const void* x, const void* g_feat, int pitch, void* g_table, long long M,
                      const HashLevels& p, int round_bf16, unsigned int combine,
                      cudaStream_t s) {
  // the largest tile (a multiple of 32 samples) whose staging fits 48 KB
  // (32 samples at 32 levels x 8 features take 33.7 KB)
  const int P = stage_pitch<F>(p.L * F);
  int tile = NGP_BWD_TILE;
  while (tile > 32 && sizeof(float) * tile * (3 + P) > 48 * 1024) tile >>= 1;
  const size_t smem = sizeof(float) * tile * (3 + P);
  hash_encode_bwd<F><<<ngp_blocks(M, tile), 32 * NGP_ENC_WARPS, smem, s>>>(
      (const float*)x, (const float*)g_feat, pitch, vec_width(g_feat, pitch), (float*)g_table, M,
      tile, p, round_bf16, combine);
  NGP_RETURN_LAST_ERROR();
}

// g_feat: [M, pitch] fp32 with pitch >= L*F (the columns past L*F are not
// read); g_table: [rows, F] fp32, zeroed, 16-byte aligned.  combine: bit l
// set where level l's adds are grouped by row before the atomics.
extern "C" int ngp_hash_encode_bwd(const void* x, const void* g_feat, int pitch, int round_bf16,
                                   int F, void* g_table, long long M, int L, const float* res,
                                   const unsigned int* offset, const unsigned int* side,
                                   int log2_size, unsigned int combine, void* stream) {
  HashLevels p;
  const int rc = fill_levels(p, L, res, offset, side, log2_size);
  if (rc != 0) return rc;
  if (pitch < L * F) return (int)cudaErrorInvalidValue;
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
