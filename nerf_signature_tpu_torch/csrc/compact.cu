// K5: global sample compaction -- pack the occupied samples of a train
// step's [N, S] march into Mc static slots, and unpack the field's results.
//
// Replaces the compaction of nerf_signature_tpu/render/renderer.py:
// render_rays_occ (the cumsum rank, the scatter into Mc + 1 slots and the
// gather back through clamp(rank)), which the JAX package runs as XLA ops.
// Its plain version is ops/compact.py:compact_plain / uncompact_plain.
//
// Over the flat M = N * S samples: rank = exclusive prefix count of mask,
// keep = mask & (rank < Mc).  pack writes, for each kept sample i,
// xyz_c[rank] = xyzs[i] and dir_c[rank] = rays_d[i / S] (the ray's
// direction, read directly rather than through the expanded [N, S, 3]
// view), slot_of[i] = rank (-1 for a sample not kept) and sample_of[rank] =
// i (-1 for an empty slot; empty slots get zero xyz and dir, as JAX's
// zeros(...).at[dst] gives them).  unpack: sigmas[i] = keep ? sig_c[slot] :
// 0, the same for rgbs.  unpack backward: the kept samples map one to one
// onto the filled slots, so g_sig_c[j] = g_sigmas[sample_of[j]] (0 for an
// empty slot) is a gather through the inverse map: no sort and no atomics,
// where autograd's indexing_backward of sig_c[clamp(rank)] sorts the
// repeated indices and accumulates.  Every value is a copy, so the kernels
// are bit-exact against the plain version, forward and backward (the
// plain backward adds only zeros to the one live term).
//
// What bounds it on the H100: bytes.  pack reads 1 B of mask a sample and
// 12 + 12 B a kept sample, writes 4 B of slot map a sample and 12 + 12 + 4
// B a slot; unpack reads 4 B of slot map a sample and writes 16 B, reading
// 16 B a kept sample; there is no arithmetic to speak of.
//
// Design: the scan is the simple three-pass one.  A tile is 1024 samples,
// 4 consecutive ones a thread (256 threads): (1) each block counts its
// tile's set bytes; (2) one block of 1024 threads scans the tile counts
// (a chunk of 1024 tiles a step, carrying the sum); (3) each block scans
// its threads' counts again (warp shuffles, then the warp sums), adds its
// tile's offset and writes its samples; the same pass clears the empty
// slots [min(total, Mc), Mc).  All three launch on the caller's stream and
// allocate nothing, so a CUDA graph can capture them.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

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

__global__ void __launch_bounds__(THREADS)
    k5_count(const unsigned char* __restrict__ mask, long long M, int* __restrict__ counts) {
  __shared__ int ws[THREADS / 32];
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  int c = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) c += (base + k < M && mask[base + k]) ? 1 : 0;
  c = __reduce_add_sync(FULL, c);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    int s = threadIdx.x < THREADS / 32 ? ws[threadIdx.x] : 0;
    s = __reduce_add_sync(FULL, s);
    if (threadIdx.x == 0) counts[blockIdx.x] = s;
  }
}

// offsets[b] <- sum of counts[0..b) in place; offsets[nb] <- the total.
__global__ void __launch_bounds__(SCAN_THREADS) k5_scan(int* __restrict__ offsets, int nb) {
  __shared__ int ws[SCAN_THREADS / 32];
  int carry = 0;
  for (int start = 0; start < nb; start += SCAN_THREADS) {
    const int b = start + threadIdx.x;
    const int v = b < nb ? offsets[b] : 0;
    int total;
    const int ex = block_exclusive_scan<SCAN_THREADS>(v, ws, &total);
    if (b < nb) offsets[b] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) offsets[nb] = carry;
}

__global__ void __launch_bounds__(THREADS)
    k5_pack(const unsigned char* __restrict__ mask, const float* __restrict__ xyzs,
            const float* __restrict__ rays_d, long long M, int S, long long Mc,
            const int* __restrict__ offsets, int nb, float* __restrict__ xyz_c,
            float* __restrict__ dir_c, int* __restrict__ slot_of, int* __restrict__ sample_of) {
  __shared__ int ws[THREADS / 32];
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  bool on[ITEMS];
  int c = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    on[k] = base + k < M && mask[base + k];
    c += on[k] ? 1 : 0;
  }
  int tile_total;
  long long rank = block_exclusive_scan<THREADS>(c, ws, &tile_total);
  if ((int)blockIdx.x < nb) rank += offsets[blockIdx.x];
  const long long total = offsets[nb];
  const long long n_kept = total < Mc ? total : Mc;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    if (i < M) {
      int slot = -1;
      if (on[k]) {
        if (rank < Mc) {
          slot = (int)rank;
          const long long n = i / S;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            xyz_c[3 * rank + a] = xyzs[3 * i + a];
            dir_c[3 * rank + a] = rays_d[3 * n + a];
          }
          sample_of[rank] = (int)i;
        }
        ++rank;
      }
      slot_of[i] = slot;
    }
    if (i < Mc && i >= n_kept) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        xyz_c[3 * i + a] = 0.0f;
        dir_c[3 * i + a] = 0.0f;
      }
      sample_of[i] = -1;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    k5_unpack(const float* __restrict__ sig_c, const float* __restrict__ rgb_c,
              const int* __restrict__ slot_of, long long M, float* __restrict__ sig,
              float* __restrict__ rgb) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < M; i += stride) {
    const int s = slot_of[i];
    if (s >= 0) {
      sig[i] = sig_c[s];
#pragma unroll
      for (int a = 0; a < 3; ++a) rgb[3 * i + a] = rgb_c[3LL * s + a];
    } else {
      sig[i] = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) rgb[3 * i + a] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    k5_unpack_bwd(const float* __restrict__ g_sig, const float* __restrict__ g_rgb,
                  const int* __restrict__ sample_of, long long Mc, float* __restrict__ g_sig_c,
                  float* __restrict__ g_rgb_c) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < Mc; j += stride) {
    const int i = sample_of[j];
    if (i >= 0) {
      g_sig_c[j] = g_sig[i];
#pragma unroll
      for (int a = 0; a < 3; ++a) g_rgb_c[3 * j + a] = g_rgb[3LL * i + a];
    } else {
      g_sig_c[j] = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) g_rgb_c[3 * j + a] = 0.0f;
    }
  }
}

// a grid-stride launch: at most 16 blocks an SM's worth (132 SMs)
inline unsigned int stride_blocks(long long n) {
  const unsigned int b = ngp_blocks(n, THREADS);
  return b < 132u * 16u ? b : 132u * 16u;
}

}  // namespace

// scratch: nb + 1 ints, nb = ceil(M / 1024).  M and Mc below 2^31.
extern "C" int ngp_compact_pack(const void* mask, const void* xyzs, const void* rays_d,
                                long long M, int S, long long Mc, void* scratch, void* xyz_c,
                                void* dir_c, void* slot_of, void* sample_of, cudaStream_t s) {
  const int nb = (int)ngp_blocks(M, TILE);
  int* offsets = (int*)scratch;
  if (nb > 0) {
    k5_count<<<nb, THREADS, 0, s>>>((const unsigned char*)mask, M, offsets);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  k5_scan<<<1, SCAN_THREADS, 0, s>>>(offsets, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = M > Mc ? M : Mc;
  if (n > 0) {
    k5_pack<<<ngp_blocks(n, TILE), THREADS, 0, s>>>(
        (const unsigned char*)mask, (const float*)xyzs, (const float*)rays_d, M, S, Mc, offsets,
        nb, (float*)xyz_c, (float*)dir_c, (int*)slot_of, (int*)sample_of);
  }
  NGP_RETURN_LAST_ERROR();
}

extern "C" int ngp_compact_unpack(const void* sig_c, const void* rgb_c, const void* slot_of,
                                  long long M, void* sig, void* rgb, cudaStream_t s) {
  if (M > 0) {
    k5_unpack<<<stride_blocks(M), THREADS, 0, s>>>((const float*)sig_c, (const float*)rgb_c,
                                                   (const int*)slot_of, M, (float*)sig,
                                                   (float*)rgb);
  }
  NGP_RETURN_LAST_ERROR();
}

extern "C" int ngp_compact_unpack_bwd(const void* g_sig, const void* g_rgb,
                                      const void* sample_of, long long Mc, void* g_sig_c,
                                      void* g_rgb_c, cudaStream_t s) {
  if (Mc > 0) {
    k5_unpack_bwd<<<stride_blocks(Mc), THREADS, 0, s>>>(
        (const float*)g_sig, (const float*)g_rgb, (const int*)sample_of, Mc, (float*)g_sig_c,
        (float*)g_rgb_c);
  }
  NGP_RETURN_LAST_ERROR();
}
