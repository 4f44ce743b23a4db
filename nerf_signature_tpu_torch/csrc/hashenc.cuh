// The hash encoders' shared device code: K1 (hashenc.cu), K7
// (hashenc_stoch.cu) and K8 (hashenc_bg.cu).  Table rows of F = 1, 2, 4 or
// 8 features, the level parameters, the corner rows and weights in the JAX
// order and with its roundings (every file that includes this is compiled
// with -fmad=false), the staging of a tile of samples and of its outputs,
// and the backward's grouped vector atomics.
#pragma once

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

// F floats at p (shared or global memory, aligned to the access)
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

// The tile's clipped positions [rows][3] into shared memory.
__device__ __forceinline__ void stage_x(float* sx, const float* __restrict__ x, long long m0,
                                        int rows) {
  for (int i = threadIdx.x; i < 3 * rows; i += blockDim.x)
    sx[i] = ngp_clip(x[m0 * 3 + i], 0.0f, 1.0f);
}

// The scaled position x * res of one (sample, level), one rounding an axis.
__device__ __forceinline__ void scale(const float (&xc)[3], float res, float (&s)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) s[a] = __fmul_rn(xc[a], res);
}

// A scaled position's cell (its floor) and fractions, one rounding an axis.
__device__ __forceinline__ void cell_of(const float (&s)[3], unsigned int (&cell)[3],
                                        float (&w)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = floorf(s[a]);
    w[a] = __fsub_rn(s[a], f);
    cell[a] = (unsigned int)f;
  }
}

// Corner c's trilinear weight (JAX's corner order and roundings).
__device__ __forceinline__ float corner_weight(const float (&w)[3], int c) {
  const float wx = (c >> 2) & 1 ? w[0] : __fsub_rn(1.0f, w[0]);
  const float wy = (c >> 1) & 1 ? w[1] : __fsub_rn(1.0f, w[1]);
  const float wz = c & 1 ? w[2] : __fsub_rn(1.0f, w[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// Corner c's row (level offset added): the dense index, or the
// XOR-of-primes hash masked to the level's size.
__device__ __forceinline__ unsigned int corner_row(const unsigned int (&cell)[3], int c,
                                                   unsigned int side, unsigned int mask,
                                                   unsigned int off) {
  const unsigned int cx = cell[0] + ((c >> 2) & 1), cy = cell[1] + ((c >> 1) & 1),
                     cz = cell[2] + (c & 1);
  if (side) return (cx * side + cy) * side + cz + off;
  return (((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) & mask) + off;
}

// The 8 corners of one scaled position: rows (level offset added) and
// trilinear weights, in the JAX corner order and with its roundings.
__device__ __forceinline__ void corners_of(const float (&s)[3], unsigned int side,
                                           unsigned int mask, unsigned int off,
                                           unsigned int (&idx)[8], float (&cw)[8]) {
  float w[3];
  unsigned int cell[3];
  cell_of(s, cell, w);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    idx[c] = corner_row(cell, c, side, mask, off);
    cw[c] = corner_weight(w, c);
  }
}

// The 8 corners of one (sample, level) from its clipped position.
__device__ __forceinline__ void corners(const float (&xc)[3], float res, unsigned int side,
                                        unsigned int mask, unsigned int off,
                                        unsigned int (&idx)[8], float (&cw)[8]) {
  float s[3];
  scale(xc, res, s);
  corners_of(s, side, mask, off, idx, cw);
}

// A tile's outputs, staged in shared memory at row pitch P, written out as
// rows * pitch contiguous floats of out from row m0, vec floats a store
// (16-byte stores when the pitch allows); the columns past L*F are zeros.
template <int F>
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float* so, long long m0,
                                           int rows, int pitch, int vec, int LF, int P) {
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

// The backward's staging: a thread's loads issued NGP_STAGE_BATCH at a time
// before their stores, so that a block's tile is in flight at once (a load
// then its store, one after the other, left each thread's loads waiting on
// one another)
#define NGP_STAGE_BATCH 4

// A tile's cotangents [rows][pitch] (their first L*F columns) into shared
// memory at row pitch P, vec floats a load (streamed: read once); where
// live is given, live[s] = 1 for each row s holding a nonzero value there
// (live zeroed beforehand).
__device__ __forceinline__ void stage_g(float* sg, unsigned int* live,
                                        const float* __restrict__ g_feat, long long m0,
                                        int rows, int pitch, int vec, int LF, int P) {
  const float* src = g_feat + m0 * pitch;
  const int n = rows * pitch / vec;
  for (int i0 = threadIdx.x; i0 < n; i0 += NGP_STAGE_BATCH * blockDim.x) {
    float v[NGP_STAGE_BATCH][4];
#pragma unroll
    for (int b = 0; b < NGP_STAGE_BATCH; ++b) {
      const int i = i0 + b * blockDim.x, e = vec * i;
      if (i < n && e % pitch < LF) {
        if (vec == 4) {
          const float4 a = __ldcs(reinterpret_cast<const float4*>(src) + i);
          v[b][0] = a.x, v[b][1] = a.y, v[b][2] = a.z, v[b][3] = a.w;
        } else if (vec == 2) {
          const float2 a = __ldcs(reinterpret_cast<const float2*>(src) + i);
          v[b][0] = a.x, v[b][1] = a.y;
        } else {
          v[b][0] = __ldcs(src + i);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NGP_STAGE_BATCH; ++b) {
      const int i = i0 + b * blockDim.x, e = vec * i, s = e / pitch, c = e - s * pitch;
      if (i >= n || c >= LF) continue;  // past the tile, or the padded columns
      bool nonzero = false;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < vec && c + q < LF) {
          sg[s * P + c + q] = v[b][q];
          nonzero = nonzero || v[b][q] != 0.0f;
        }
      if (live != nullptr && nonzero) live[s] = 1u;
    }
  }
}

// One vector atomic add of a row's F contributions (sm_90's float2 / float4
// atomicAdd in global memory; two float4 at F = 8), fire-and-forget (RED).
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

// One warp-wide add of each lane's contribution v into its row (lanes with
// ``any`` false add nothing; every lane of the warp calls it): with
// ``grouped``, the lanes adding into one row are matched and summed into the
// group's lowest lane first (one atomic a group), else one atomic a lane.
template <int F>
__device__ __forceinline__ void warp_add(float* g_table, unsigned int row, float (&v)[F],
                                         bool any, bool grouped, int lane) {
  if (grouped) {
    const unsigned int adding = __ballot_sync(NGP_FULL, any);
    if (adding == 0u) return;
    unsigned int peers = 0u;
    if (any) peers = __match_any_sync(adding, row);
    reduce_peers<F>(peers, lane, v);
    if (any && (peers & ((1u << lane) - 1u)) == 0u) add_row<F>(g_table, row, v);
  } else if (any) {
    add_row<F>(g_table, row, v);
  }
}

// The level block a C entry of K1 or K7 is handed, prepared once per table
// geometry on the host (ops/hashenc.py:level_args, a ctypes copy of this
// struct): checked, then passed to the kernel by value.
static inline int take_levels(HashLevels& p, const HashLevels* levels) {
  if (levels == nullptr || levels->L < 1 || levels->L > NGP_MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  p = *levels;
  return 0;
}

static inline int fill_levels(HashLevels& p, int L, const float* res, const unsigned int* offset,
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
static inline int vec_width(const void* ptr, int pitch) {
  const unsigned long long a = (unsigned long long)ptr;
  if (pitch % 4 == 0 && a % 16 == 0) return 4;
  if (pitch % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

// The largest backward tile (a multiple of 32 samples, at most NGP_BWD_TILE)
// whose staging fits 48 KB (32 samples at 32 levels x 8 features take 33.7 KB)
static inline int bwd_tile(int P) {
  int tile = NGP_BWD_TILE;
  while (tile > 32 && sizeof(float) * tile * (3 + P) > 48 * 1024) tile >>= 1;
  return tile;
}
