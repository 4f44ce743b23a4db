// K6: the occupancy-grid update -- everything around the density queries
// of one maintenance step, written into the grid's own tensors.
//
// Replaces nerf_signature_tpu/ops/grid.py:update_occupancy_grid (:136), which
// the JAX package runs as XLA ops (the reference ran it on its own CUDA
// kernels).  Its plain version is ops/grid.py:update_occupancy_grid with
// plain=True.  The queries between these kernels stay K1 + K4 (the model's
// density_fn), in the same chunks.
//
// Per cascade of C, over its H^3 cells (row-major (x*H + y)*H + z):
// * k6_occupied (partial update only): the occupied cells (density > 0) in
//   index order and their count, for every cascade in one single-pass stream
//   compaction with a decoupled look-back (lookback.cuh, shared with K5's
//   pack): tiles of 2048 cells, 16 a thread; a cascade's count is its last
//   tile's inclusive prefix, left in the scratch's status word.
// * k6_points: one thread a query writes its jittered world position and
//   (partial update) its cell as int32.  Full update: the cell is the query's
//   index.  Partial: the first H^3/4 queries take rand_coords (int64 or
//   int32); the next H^3/4 the occupied cell of the inverse CDF: over the
//   exact integer cdf of the plain version (its cumsum of a 0/1 mask, exact
//   while H^3 <= 2^24), searchsorted(cdf, u) (side left) with u = occ_u *
//   count as one fp32 product is the ceil(u)-th occupied cell; u = 0 gives
//   cell 0; with no occupied cell the cdf is 1..H^3 (the uniform fallback),
//   read from the count on the device, nothing read back.  The position
//   repeats the plain version's separate fp32 roundings as PyTorch computes
//   them on the card (the true divide by H - 1 as a product with the host's
//   fp32 reciprocal; -fmad=false keeps every product and sum apart).
// * k6_scatter (partial update only): tmp[cell] = sigma * density_scale,
//   the last query of a cell winning as in a sequential scatter: one 64-bit
//   atomicMax a query of ((pos + 1) << 32) | bits(value) into a word a cell,
//   zeroed by k6_occupied's call; a word of 0 reads as tmp = -1 (not
//   queried).  The full update needs no scatter: its queries are the cells.
// * k6_finalize: one pass over the cells, each cell's reads and writes in
//   one thread, in place: valid = density >= 0 & tmp >= 0; density =
//   valid ? max(density * decay, tmp) : density; live = valid ? tmp : live;
//   and clamp_min(density, 0) into a buffer whose mean PyTorch takes (the
//   plain version's own reduction, so mean and threshold stay bit-equal).
// * k6_threshold: occupancy = density > min(mean, density_thresh), and
//   iter_density += 1, on the device.
//
// What bounds it on the H100: bytes (no arithmetic to speak of): the grid's
// density and live arrays read and written, its bitfield written, the
// draws read, a position written and a sigma read a query; the occupied list
// and the scatter's words are the intermediates.  Every pass reads and
// writes consecutive addresses with a warp's lanes side by side.
//
// All launches go on the caller's stream and allocate nothing: the caller
// keeps the buffers (ops/grid.py:_buffers, once per device, C and H).

#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int OCC_THREADS = 128;
constexpr int OCC_ITEMS = 16;  // cells a thread: four float4 of density
constexpr int OCC_TILE = OCC_THREADS * OCC_ITEMS;

// scratch: [0] the tile counter, [1 + c * tiles + b] cascade c's tile b's
// status word; zero at launch.  list: [C, H3], cascade c's occupied cells
// from c * H3 in index order.
__global__ void __launch_bounds__(OCC_THREADS)
    k6_occupied(const float* __restrict__ density, long long H3, int tiles,
                unsigned long long* __restrict__ scratch, int* __restrict__ list) {
  __shared__ int sidx[OCC_TILE];  // the tile's occupied cells in order
  __shared__ int ws[OCC_THREADS / 32];
  __shared__ int s_tile;
  __shared__ long long s_off;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  const int id = s_tile, cas = id / tiles, tile = id - cas * tiles;
  unsigned long long* status = scratch + 1 + (long long)cas * tiles;
  const long long start = (long long)tile * OCC_TILE;
  const int len = (int)(start + OCC_TILE < H3 ? OCC_TILE : H3 - start);
  const float* d = density + cas * H3 + start;
  const int first = threadIdx.x * OCC_ITEMS;

  // bit k of on <- cell start + first + k is occupied
  unsigned on = 0;
  if (first + OCC_ITEMS <= len && aligned16(d)) {
#pragma unroll
    for (int q = 0; q < OCC_ITEMS / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(d + first)[q];
      on |= ((unsigned)(v.x > 0.0f) | ((unsigned)(v.y > 0.0f) << 1) |
             ((unsigned)(v.z > 0.0f) << 2) | ((unsigned)(v.w > 0.0f) << 3))
            << (4 * q);
    }
  } else {
#pragma unroll
    for (int k = 0; k < OCC_ITEMS; ++k)
      if (first + k < len && d[first + k] > 0.0f) on |= 1u << k;
  }
  int agg;
  const int lr = block_exclusive_scan<OCC_THREADS>(__popc(on), ws, &agg);
  if (threadIdx.x == 0)
    store_release(status + tile, (tile == 0 ? FLAG_INCLUSIVE : FLAG_AGGREGATE) | (unsigned)agg);
  for (unsigned bits = on, r = lr; bits; bits &= bits - 1, ++r)
    sidx[r] = (int)(start + first + __ffs(bits) - 1);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long excl = 0;
    if (tile > 0) {
      excl = look_back(status, tile, lane);
      if (lane == 0)
        store_release(status + tile, FLAG_INCLUSIVE | (unsigned long long)(excl + agg));
    }
    if (lane == 0) s_off = excl;
  }
  __syncthreads();
  const long long off = s_off;
  store_run<int4>(list + cas * H3, off, off + agg, threadIdx.x, OCC_THREADS,
                  [&](long long q) { return sidx[q - off]; });
}

// One query a thread: the cell, then its jittered position.  rc64 / rc32:
// the partial update's random cells (one of them set; both null for the
// full update), q of them, then n - q occupied-cell resamples from occ_u.
// count: the cascade's last status word (its occupied count) or null.
__global__ void __launch_bounds__(THREADS)
    k6_points(long long n, int H, long long q, const float* __restrict__ jitter,
              const long long* __restrict__ rc64, const int* __restrict__ rc32,
              const float* __restrict__ occ_u, const int* __restrict__ list,
              const unsigned long long* __restrict__ count, float inv, float scale,
              float half, float* __restrict__ pos, int* __restrict__ cell) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long H3 = (long long)H * H * H;
  long long c[3];
  if (rc64 == nullptr && rc32 == nullptr) {  // the full update: cell i
    c[0] = i / ((long long)H * H);
    c[1] = (i / H) % H;
    c[2] = i % H;
  } else {
    if (i < q) {
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] = rc64 ? rc64[3 * i + a] : (long long)rc32[3 * i + a];
    } else {
      // searchsorted(cdf, u) over cdf = cumsum(occupied), or 1..H3 where
      // nothing is occupied, clamped to [0, H3 - 1]
      const unsigned occupied = (unsigned)*count;
      const float total = occupied ? (float)occupied : (float)H3;
      const float u = occ_u[i - q] * total;
      long long k;
      if (u <= 0.0f) {
        k = 0;
      } else if (u <= total) {
        const long long r = (long long)ceilf(u) - 1;  // the ceil(u)-th, from 0
        k = occupied ? (long long)list[r] : r;
      } else {  // NaN: past the cdf's end
        k = H3 - 1;
      }
      c[0] = k / ((long long)H * H);
      c[1] = (k / H) % H;
      c[2] = k % H;
    }
    cell[i] = (int)((c[0] * H + c[1]) * H + c[2]);
  }
  // (2 c / (H - 1) - 1) * (cas_bound - half) + jitter * half, rounded as the
  // plain version's separate ops
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float p = 2.0f * (float)c[a];
    p = p * inv;
    p = p - 1.0f;
    p = p * scale;
    pos[3 * i + a] = p + jitter[3 * i + a] * half;
  }
}

// queries pos0 .. pos0 + n - 1 of a cascade: sig [n] their raw sigmas, cell
// [pos0 + n] their cells; words [H3] the cascade's
__global__ void __launch_bounds__(THREADS)
    k6_scatter(const float* __restrict__ sig, const int* __restrict__ cell, long long n,
               long long pos0, float density_scale, unsigned long long* __restrict__ words) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float v = sig[i] * density_scale;
  const unsigned long long w =
      ((unsigned long long)(pos0 + i + 1) << 32) | (unsigned long long)__float_as_uint(v);
  atomicMax(words + cell[pos0 + i], w);
}

// n cells from the pointers given: tmp from sig (the full update's queries,
// times density_scale) or from words (the partial update's scatter)
__global__ void __launch_bounds__(THREADS)
    k6_finalize(float* __restrict__ density, float* __restrict__ live,
                float* __restrict__ clamped, const float* __restrict__ sig,
                const unsigned long long* __restrict__ words, long long n, float density_scale,
                float decay) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float t;
  if (sig != nullptr) {
    t = sig[i] * density_scale;
  } else {
    const unsigned long long w = words[i];
    t = w ? __uint_as_float((unsigned)w) : -1.0f;
  }
  const float d = density[i];
  const bool valid = d >= 0.0f && t >= 0.0f;
  // torch.maximum's NaN test is moot here: valid excludes NaN
  const float nd = valid ? fmaxf(d * decay, t) : d;
  density[i] = nd;
  if (valid) live[i] = t;
  clamped[i] = isnan(nd) ? nd : fmaxf(nd, 0.0f);  // torch.clamp_min(., 0)
}

__global__ void __launch_bounds__(THREADS)
    k6_threshold(const float* __restrict__ density, long long n, const float* __restrict__ mean,
                 float density_thresh, bool* __restrict__ occupancy, int* __restrict__ iter) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float m = *mean;
  const float thresh = isnan(m) ? m : fminf(m, density_thresh);  // torch.clamp_max
  if (i < n) occupancy[i] = density[i] > thresh;
  if (i == 0) *iter += 1;
}

}  // namespace

// The partial update's first call: zero the scratch (1 + C * tiles words,
// tiles = ceil(H3 / 2048)) and the scatter's words (C * H3), then the
// occupied lists of all C cascades.  H3 at most 2^24.
extern "C" int ngp_grid_occupied(const void* density, long long H3, int C, void* scratch,
                                 void* list, void* words, cudaStream_t s) {
  const long long tiles = (H3 + OCC_TILE - 1) / OCC_TILE;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (1 + C * tiles) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(words, 0, C * H3 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  if (C * tiles > 0)
    k6_occupied<<<(unsigned int)(C * tiles), OCC_THREADS, 0, s>>>(
        (const float*)density, H3, (int)tiles, (unsigned long long*)scratch, (int*)list);
  NGP_RETURN_LAST_ERROR();
}

// rc: the partial update's random cells (rc_int64: their type), or null for
// the full update (then q, occ_u, list, count and cell are unused)
extern "C" int ngp_grid_points(long long n, int H, long long q, const void* jitter,
                               const void* rc, int rc_int64, const void* occ_u,
                               const void* list, const void* count, float inv, float scale,
                               float half, void* pos, void* cell, cudaStream_t s) {
  if (n > 0)
    k6_points<<<ngp_blocks(n, THREADS), THREADS, 0, s>>>(
        n, H, q, (const float*)jitter, rc_int64 ? (const long long*)rc : nullptr,
        rc_int64 ? nullptr : (const int*)rc, (const float*)occ_u, (const int*)list,
        (const unsigned long long*)count, inv, scale, half, (float*)pos, (int*)cell);
  NGP_RETURN_LAST_ERROR();
}

extern "C" int ngp_grid_scatter(const void* sig, const void* cell, long long n, long long pos0,
                                float density_scale, void* words, cudaStream_t s) {
  if (n > 0)
    k6_scatter<<<ngp_blocks(n, THREADS), THREADS, 0, s>>>(
        (const float*)sig, (const int*)cell, n, pos0, density_scale,
        (unsigned long long*)words);
  NGP_RETURN_LAST_ERROR();
}

// sig (the full update) or words (the partial one): the other null
extern "C" int ngp_grid_finalize(void* density, void* live, void* clamped, const void* sig,
                                 const void* words, long long n, float density_scale,
                                 float decay, cudaStream_t s) {
  if (n > 0)
    k6_finalize<<<ngp_blocks(n, THREADS), THREADS, 0, s>>>(
        (float*)density, (float*)live, (float*)clamped, (const float*)sig,
        (const unsigned long long*)words, n, density_scale, decay);
  NGP_RETURN_LAST_ERROR();
}

extern "C" int ngp_grid_threshold(const void* density, long long n, const void* mean,
                                  float density_thresh, void* occupancy, void* iter,
                                  cudaStream_t s) {
  k6_threshold<<<n > 0 ? ngp_blocks(n, THREADS) : 1u, THREADS, 0, s>>>(
      (const float*)density, n, (const float*)mean, density_thresh, (bool*)occupancy,
      (int*)iter);
  NGP_RETURN_LAST_ERROR();
}
