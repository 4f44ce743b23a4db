// The single-pass stream compaction's shared parts (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016): a
// block's exclusive scan, the tile status words (flag and value in one
// 64-bit word, published with st.release.gpu and read with ld.acquire.gpu),
// the look-back over a tile's predecessors, and the vector stores of a
// contiguous run.  Used by K5's pack (compact.cu) and K6's occupied-cell
// list (grid.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// a tile's status word: flag << 32 | value (a count or prefix below 2^31)
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;
constexpr unsigned long long FLAG_INCLUSIVE = 2ull << 32;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// p[q] = val(q) for q in [q0, q1), by the threads t = 0 .. nt - 1 of a
// stride: vectors of 4 (V4: float4 or int4) over the 16-byte aligned groups
// inside the range, scalars for the head and tail around them (and for the
// whole range where p is unaligned).
template <typename V4, typename T, typename F>
__device__ __forceinline__ void store_run(T* p, long long q0, long long q1, long long t,
                                          long long nt, F val) {
  const long long a0 = (q0 + 3) & ~3LL, a1 = q1 & ~3LL;
  if (!aligned16(p) || a0 >= a1) {
    for (long long q = q0 + t; q < q1; q += nt) p[q] = val(q);
    return;
  }
  for (long long q = q0 + t; q < a0; q += nt) p[q] = val(q);
  for (long long q = a1 + t; q < q1; q += nt) p[q] = val(q);
  for (long long g = (a0 >> 2) + t; g < (a1 >> 2); g += nt) {
    const long long q = g << 2;
    V4 w;
    w.x = val(q);
    w.y = val(q + 1);
    w.z = val(q + 2);
    w.w = val(q + 3);
    reinterpret_cast<V4*>(p)[g] = w;
  }
}

// Exclusive scan of one int a thread over the block; *total gets the sum.
// ws holds one int a warp.  Ends with a barrier, so ws may be reused.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* ws, int* total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NW ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NW) ws[lane] = w;
  }
  __syncthreads();
  const int ex = x - v + (warp > 0 ? ws[warp - 1] : 0);
  *total = ws[NW - 1];
  __syncthreads();
  return ex;
}

// The exclusive prefix of tile ``tile`` (> 0), by one warp: lane l reads
// the status word of tile top - l, top = tile - 1 first.  The window is read
// again until every lane up to the nearest inclusive prefix (all 32 where
// there is none) has published; their values are summed, and the window
// moves 32 tiles back until an inclusive prefix ends the walk.  Before tile
// 0 reads as an inclusive prefix of 0.
__device__ __forceinline__ long long look_back(const unsigned long long* status, int tile,
                                               int lane) {
  long long excl = 0;
  int top = tile - 1;
  while (true) {
    const int p = top - lane;
    const unsigned long long s = p >= 0 ? load_acquire(status + p) : FLAG_INCLUSIVE;
    const unsigned incl = __ballot_sync(FULL, (s >> 32) == 2);
    const unsigned ready = __ballot_sync(FULL, (s >> 32) != 0);
    // lanes 0 .. the nearest inclusive prefix's
    const unsigned need = incl ? ((incl & (0u - incl)) << 1) - 1u : FULL;
    if ((ready & need) != need) continue;
    excl += __reduce_add_sync(FULL, (need >> lane) & 1u ? (unsigned)s : 0u);
    if (incl) return excl;
    top -= 32;
  }
}

}  // namespace
