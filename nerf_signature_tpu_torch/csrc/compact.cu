// K5: global sample compaction -- pack the occupied samples of a train
// step's [N, S] march into Mc static slots, and unpack the field's results.
//
// Replaces the compaction of nerf_signature_tpu/render/renderer.py:
// render_rays_occ (the cumsum rank, the scatter into Mc + 1 slots and the
// gather back through clamp(rank)), which the JAX package runs as XLA ops.
// Its plain version is ops/compact.py:compact_plain / uncompact_plain.
//
// Over the flat M = N * S samples: rank = exclusive prefix count of mask,
// keep = mask & (rank < cap), where cap is Mc, or, given a device scalar
// (one rank of a data-parallel group: parallel/mesh.py:compaction_cap),
// that scalar clamped to [0, Mc]; Mc is the slot buffer's size.  pack
// writes, for each kept sample i, xyz_c[rank] = xyzs[i] and dir_c[rank] =
// rays_d[i / S] (the ray's direction, read directly rather than through the
// expanded [N, S, 3] view), slot_of[i] = rank (-1 for a sample not kept)
// and sample_of[rank] = i (-1 for an empty slot; empty slots get zero xyz
// and dir, as JAX's zeros(...).at[dst] gives them).  unpack: sigmas[i] = keep ? sig_c[slot] :
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
// 16 B a kept sample; its backward reads 4 B of sample map a slot and writes
// 16 B, reading 16 B of cotangent a kept sample; there is no arithmetic to
// speak of.
//
// Design: the pack is a single-pass stream compaction with a decoupled
// look-back scan (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016), then one small launch for the empty slots.
// * A block takes a tile of PACK_TILE = 2048 samples, 16 a thread, read as
//   one uint4 of mask (bytes, scalar where the tile is ragged or the
//   pointer unaligned), and its tile id from a counter in the scratch
//   (atomicAdd), so ids follow the order in which blocks start: a tile waits
//   only on tiles that are already running, whatever the grid's size.
// * The block ranks its set samples (popc of each thread's 16 bits, a warp
//   shuffle scan, the warp sums) and publishes its tile's count in its
//   status word (flag and value in one 64-bit word, st.release.gpu; tile 0
//   its inclusive prefix).  It then starts asynchronous copies (cp.async)
//   of the tile's rays and of the 16-byte groups of its positions that
//   touch a set sample into shared memory, side by side, and stages the
//   set samples' indices in rank order.  Meanwhile its first warp looks
//   back over the predecessors' status words (ld.acquire.gpu), 32 at a
//   time, summing counts until it meets an inclusive prefix, and publishes
//   its own inclusive prefix (st.release.gpu).
// * With its offset known, the block writes slot_of for its samples as
//   int4 (groups of 4 samples side by side), and the contiguous slot range
//   [offset, offset + kept) of xyz_c, dir_c and sample_of as float4 / int4
//   streams (a scalar head and tail) from shared memory.  A ray's
//   direction is read once a tile: K2 writes a ray's samples as a prefix
//   of its S slots, so a tile of 2048 samples spans at most 2048 / S + 1
//   rays, staged where that is at most RAY_CAP (S >= 9; shorter rays read
//   rays_d in place).  Nothing assumes the prefix: any mask packs the same.
// * k5_pack_fill then clears the empty slots [min(total, cap), Mc): the
//   total is the last tile's inclusive prefix, known only once every tile
//   is done.  It is a grid-stride launch of its own: left to the last
//   block, a third of the slots or more would be written by one SM.
// * The counter and the status words are cleared by a cudaMemsetAsync on
//   the caller's stream at every call, so every replay of a CUDA graph that
//   captured the pack starts clean.  A memset and two launches, all on the
//   caller's stream, allocating nothing: a CUDA graph can capture them.
// * The unpack: a block takes a tile of UNPACK_TILE = 1024 consecutive
//   samples (the grid covers M in tiles), reads their slot map as one int4
//   a thread into shared memory, then, a warp's lanes on consecutive
//   samples, gathers each kept sample's sigma and rgb row (a tile's kept
//   samples hold consecutive slots, so the loads are coalesced) or writes
//   zeros, and stores the tile's sigmas and its 3 x 1024 rgb floats as two
//   contiguous spans in 16-byte stores from shared memory.  The unpack
//   backward is the same gather through the inverse map (gather_tile, one
//   body for both kernels): tiles of 1024 consecutive slots, sample_of
//   read as int4, a warp's lanes on consecutive slots (the kept slots hold
//   increasing samples, consecutive within a ray's prefix, so the loads of
//   the cotangents are coalesced), g_sig_c and g_rgb_c stored as two spans
//   in 16-byte stores, the empty slots as zeros.

#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PACK_THREADS = 128;
constexpr int PACK_ITEMS = 16;  // one uint4 of mask a thread
constexpr int PACK_TILE = PACK_THREADS * PACK_ITEMS;
constexpr int RAY_CAP = 256;    // rays a tile stages (S >= 9); more: read in place
constexpr int UNPACK_ITEMS = 4;  // one int4 of slot map a thread
constexpr int UNPACK_TILE = THREADS * UNPACK_ITEMS;

// asynchronous copies from global to shared memory (no registers held):
// 16 bytes (both addresses 16-byte aligned) or 4; cp_async_wait() waits
// for this thread's copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// dst[0, n) = src[0, n) (src in shared memory, 16-byte aligned) by the
// block's THREADS threads: float4 stores side by side where dst is 16-byte
// aligned, scalars for the tail (and everywhere where it is not).
__device__ __forceinline__ void store_span(float* dst, const float* src, int n) {
  int q = 0;
  if (aligned16(dst)) {
    for (int g = threadIdx.x; g < n / 4; g += THREADS)
      reinterpret_cast<float4*>(dst)[g] = reinterpret_cast<const float4*>(src)[g];
    q = n & ~3;
  }
  for (q += threadIdx.x; q < n; q += THREADS) dst[q] = src[q];
}

// The cap on the kept samples: *cap_p clamped to [0, Mc], Mc without one.
__device__ __forceinline__ long long read_cap(const long long* cap_p, long long Mc) {
  if (!cap_p) return Mc;
  const long long c = *cap_p;
  return c < 0 ? 0 : (c < Mc ? c : Mc);
}

// scratch: [0] the tile counter, [1 + b] tile b's status word; zero at launch
__global__ void __launch_bounds__(PACK_THREADS)
    k5_pack(const unsigned char* __restrict__ mask, const float* __restrict__ xyzs,
            const float* __restrict__ rays_d, long long M, int S, long long Mc,
            const long long* __restrict__ cap_p, unsigned long long* __restrict__ scratch,
            float* __restrict__ xyz_c, float* __restrict__ dir_c, int* __restrict__ slot_of,
            int* __restrict__ sample_of) {
  constexpr int GROUPS = 3 * PACK_TILE / 4 / PACK_THREADS;  // float4s of xyzs a thread
  __shared__ int sidx[PACK_TILE];                      // the set samples in rank order
  __shared__ __align__(16) float sxyz[3 * PACK_TILE];  // the tile's positions, where set
  __shared__ float sray[3 * RAY_CAP];                  // the tile's rays
  __shared__ unsigned son[PACK_THREADS];               // each thread's mask bits
  __shared__ int slr[PACK_THREADS];                    // and its first rank
  __shared__ int ws[PACK_THREADS / 32];
  __shared__ int s_tile;
  __shared__ long long s_off;
  unsigned long long* status = scratch + 1;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  const int tile = s_tile;
  const long long start = (long long)tile * PACK_TILE;
  const int len = (int)(start + PACK_TILE < M ? PACK_TILE : M - start);
  const int first = threadIdx.x * PACK_ITEMS;

  // one read of the mask: bit k of on <- sample start + first + k is set
  unsigned on = 0;
  if (first + PACK_ITEMS <= len && aligned16(mask + start)) {
    const uint4 mv = *reinterpret_cast<const uint4*>(mask + start + first);
    const unsigned w[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned b = __vcmpne4(w[q], 0u);  // 0xff in each set byte
      on |= ((b & 1u) | ((b >> 7) & 2u) | ((b >> 14) & 4u) | ((b >> 21) & 8u)) << (4 * q);
    }
  } else {
#pragma unroll
    for (int k = 0; k < PACK_ITEMS; ++k)
      if (first + k < len && mask[start + first + k]) on |= 1u << k;
  }
  son[threadIdx.x] = on;
  int agg;
  const int lr = block_exclusive_scan<PACK_THREADS>(__popc(on), ws, &agg);  // son visible
  if (threadIdx.x == 0)
    store_release(status + tile, (tile == 0 ? FLAG_INCLUSIVE : FLAG_AGGREGATE) | (unsigned)agg);
  slr[threadIdx.x] = lr;

  // copies into shared memory, in flight through the look-back: the tile's
  // rays [r0, r0 + nr), where they fit, and the float4s g = t +
  // PACK_THREADS u of the tile's 3 * len position floats that touch a set
  // sample (side by side; scalars at a ragged end or an unaligned xyzs)
  const long long r0 = start / S;
  const int nr = (int)((start + len - 1) / S - r0 + 1);
  const bool rays_staged = nr <= RAY_CAP;
  if (rays_staged)
    for (int e = threadIdx.x; e < 3 * nr; e += PACK_THREADS)
      cp_async4(sray + e, rays_d + 3 * r0 + e);
  const float* xt = xyzs + 3 * start;
  const bool xyz_vec = aligned16(xt);
#pragma unroll
  for (int u = 0; u < GROUPS; ++u) {
    const int g = threadIdx.x + PACK_THREADS * u, s0 = 4 * g / 3, s1 = (4 * g + 3) / 3;
    if (((son[s0 / PACK_ITEMS] >> (s0 % PACK_ITEMS)) & 1u) |
        ((son[s1 / PACK_ITEMS] >> (s1 % PACK_ITEMS)) & 1u)) {
      if (xyz_vec && 4 * g + 4 <= 3 * len) {
        cp_async16(sxyz + 4 * g, xt + 4 * g);
      } else {
        for (int c = 0; c < 4 && 4 * g + c < 3 * len; ++c)
          cp_async4(sxyz + 4 * g + c, xt + 4 * g + c);
      }
    }
  }

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
  // the set samples' indices in rank order
  for (unsigned bits = on, r = lr; bits; bits &= bits - 1, ++r)
    sidx[r] = (int)(start + first + __ffs(bits) - 1);
  cp_async_wait();
  __syncthreads();
  const long long off = s_off;
  const long long cap = read_cap(cap_p, Mc);
  const long long room = cap - off;
  const long long kept = room <= 0 ? 0 : (room < agg ? room : agg);

  // slot_of (the slot, -1 where not kept) by groups of 4 samples, g = t +
  // PACK_THREADS u: int4 stores side by side
#pragma unroll
  for (int u = 0; u < PACK_ITEMS / 4; ++u) {
    const int g = threadIdx.x + PACK_THREADS * u, owner = g / 4, b0 = 4 * (g % 4);
    const unsigned bits = son[owner];
    long long r = off + slr[owner] + __popc(bits & ((1u << b0) - 1u));
    int slot[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      slot[c] = -1;
      if ((bits >> (b0 + c)) & 1u) {
        if (r < cap) slot[c] = (int)r;
        ++r;
      }
    }
    if (4 * g + 4 <= len && aligned16(slot_of + start)) {
      reinterpret_cast<int4*>(slot_of + start)[g] = make_int4(slot[0], slot[1], slot[2], slot[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * g + c < len) slot_of[start + 4 * g + c] = slot[c];
    }
  }

  // the slots [off, off + kept): positions, directions, sample indices
  const long long t = threadIdx.x, q0 = 3 * off, q1 = 3 * (off + kept);
  store_run<float4>(xyz_c, q0, q1, t, PACK_THREADS, [&](long long q) {
    const int e = (int)(q - q0), j = e / 3;
    return sxyz[3 * (sidx[j] - start) + (e - 3 * j)];
  });
  store_run<float4>(dir_c, q0, q1, t, PACK_THREADS, [&](long long q) {
    const int e = (int)(q - q0), j = e / 3, a = e - 3 * j;
    const long long n = sidx[j] / S;
    return rays_staged ? sray[3 * (n - r0) + a] : rays_d[3 * n + a];
  });
  store_run<int4>(sample_of, off, off + kept, t, PACK_THREADS,
                  [&](long long q) { return sidx[q - off]; });
}

// The empty slots [min(total, cap), Mc): zero position and direction,
// sample -1.  last: the last tile's status word (its inclusive prefix, the
// total), or null for M = 0.
__global__ void __launch_bounds__(THREADS)
    k5_pack_fill(const unsigned long long* __restrict__ last, long long Mc,
                 const long long* __restrict__ cap_p, float* __restrict__ xyz_c,
                 float* __restrict__ dir_c, int* __restrict__ sample_of) {
  const long long total = last ? (long long)(unsigned)*last : 0;
  const long long cap = read_cap(cap_p, Mc);
  const long long n_kept = total < cap ? total : cap;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nt = (long long)gridDim.x * THREADS;
  store_run<float4>(xyz_c, 3 * n_kept, 3 * Mc, t, nt, [](long long) { return 0.0f; });
  store_run<float4>(dir_c, 3 * n_kept, 3 * Mc, t, nt, [](long long) { return 0.0f; });
  store_run<int4>(sample_of, n_kept, Mc, t, nt, [](long long) { return -1; });
}

// One tile of a gather through a map, UNPACK_TILE consecutive outputs j a
// block: dst_sig[j] = src_sig[map[j]] and dst_rgb[j] = src_rgb[map[j]] (rows
// of 3), zeros where map[j] = -1; n outputs in all.  The unpack: map =
// slot_of over the samples; its backward: map = sample_of over the slots.
__device__ __forceinline__ void gather_tile(const float* __restrict__ src_sig,
                                            const float* __restrict__ src_rgb,
                                            const int* __restrict__ map, long long n,
                                            float* __restrict__ dst_sig,
                                            float* __restrict__ dst_rgb) {
  __shared__ __align__(16) int smap[UNPACK_TILE];         // the tile's map
  __shared__ __align__(16) float osig[UNPACK_TILE];       // its sigmas
  __shared__ __align__(16) float orgb[3 * UNPACK_TILE];   // and rgb rows
  const long long m0 = (long long)blockIdx.x * UNPACK_TILE;
  const int len = (int)(m0 + UNPACK_TILE < n ? UNPACK_TILE : n - m0);

  // the map: UNPACK_ITEMS entries a thread, one int4 (scalars at a ragged
  // end or an unaligned map; -1 past the end)
  const int first = threadIdx.x * UNPACK_ITEMS;
  if (first + UNPACK_ITEMS <= len && aligned16(map + m0)) {
    reinterpret_cast<int4*>(smap)[threadIdx.x] =
        reinterpret_cast<const int4*>(map + m0)[threadIdx.x];
  } else {
#pragma unroll
    for (int c = 0; c < UNPACK_ITEMS; ++c)
      smap[first + c] = first + c < len ? map[m0 + first + c] : -1;
  }
  __syncthreads();

  // output j = t + THREADS k: a warp's lanes on consecutive outputs, whose
  // sources are consecutive where they are live (the pack keeps sample
  // order), so the loads of src_sig and src_rgb are coalesced; shared
  // accesses at a stride of 1 and 3 words take distinct banks
  float v[UNPACK_ITEMS][4];
#pragma unroll
  for (int k = 0; k < UNPACK_ITEMS; ++k) {
    const int s = smap[threadIdx.x + THREADS * k];
    if (s >= 0) {
      v[k][0] = src_sig[s];
#pragma unroll
      for (int a = 0; a < 3; ++a) v[k][1 + a] = src_rgb[3LL * s + a];
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) v[k][a] = 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < UNPACK_ITEMS; ++k) {
    const int j = threadIdx.x + THREADS * k;
    osig[j] = v[k][0];
#pragma unroll
    for (int a = 0; a < 3; ++a) orgb[3 * j + a] = v[k][1 + a];
  }
  __syncthreads();

  // the tile's spans dst_sig[m0, m0 + len) and dst_rgb[3 m0, 3 (m0 + len))
  // from shared memory, in 16-byte stores side by side
  store_span(dst_sig + m0, osig, len);
  store_span(dst_rgb + 3 * m0, orgb, 3 * len);
}

// unpack: a block takes a tile of UNPACK_TILE consecutive samples
__global__ void __launch_bounds__(THREADS)
    k5_unpack(const float* __restrict__ sig_c, const float* __restrict__ rgb_c,
              const int* __restrict__ slot_of, long long M, float* __restrict__ sig,
              float* __restrict__ rgb) {
  gather_tile(sig_c, rgb_c, slot_of, M, sig, rgb);
}

// unpack backward: a block takes a tile of UNPACK_TILE consecutive slots
__global__ void __launch_bounds__(THREADS)
    k5_unpack_bwd(const float* __restrict__ g_sig, const float* __restrict__ g_rgb,
                  const int* __restrict__ sample_of, long long Mc, float* __restrict__ g_sig_c,
                  float* __restrict__ g_rgb_c) {
  gather_tile(g_sig, g_rgb, sample_of, Mc, g_sig_c, g_rgb_c);
}

}  // namespace

// scratch: nt + 1 64-bit words, nt = ceil(M / PACK_TILE).  M and Mc below
// 2^31.  cap: null, or one int64 on the device (read by the kernels, so a
// CUDA graph replays with the value of the moment).
extern "C" int ngp_compact_pack(const void* mask, const void* xyzs, const void* rays_d,
                                long long M, int S, long long Mc, const void* cap,
                                void* scratch, void* xyz_c, void* dir_c, void* slot_of,
                                void* sample_of, cudaStream_t s) {
  const long long nt = (M + PACK_TILE - 1) / PACK_TILE;
  unsigned long long* words = (unsigned long long*)scratch;
  if (nt > 0) {
    cudaError_t err = cudaMemsetAsync(words, 0, (nt + 1) * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    k5_pack<<<(unsigned int)nt, PACK_THREADS, 0, s>>>(
        (const unsigned char*)mask, (const float*)xyzs, (const float*)rays_d, M, S, Mc,
        (const long long*)cap, words, (float*)xyz_c, (float*)dir_c, (int*)slot_of,
        (int*)sample_of);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (Mc > 0) {
    // at most 4 blocks an SM's worth: most slots are full
    const unsigned int b = ngp_blocks((3 * Mc + 3) / 4, THREADS);
    k5_pack_fill<<<b < 132u * 4u ? b : 132u * 4u, THREADS, 0, s>>>(
        nt > 0 ? words + nt : nullptr, Mc, (const long long*)cap, (float*)xyz_c,
        (float*)dir_c, (int*)sample_of);
  }
  NGP_RETURN_LAST_ERROR();
}

// M below 2^31.  sig [M] and rgb [M, 3] may be views of one buffer.
extern "C" int ngp_compact_unpack(const void* sig_c, const void* rgb_c, const void* slot_of,
                                  long long M, void* sig, void* rgb, cudaStream_t s) {
  if (M > 0) {
    k5_unpack<<<(unsigned int)((M + UNPACK_TILE - 1) / UNPACK_TILE), THREADS, 0, s>>>(
        (const float*)sig_c, (const float*)rgb_c, (const int*)slot_of, M, (float*)sig,
        (float*)rgb);
  }
  NGP_RETURN_LAST_ERROR();
}

// Mc below 2^31.  g_sig_c [Mc] and g_rgb_c [Mc, 3] may be views of one
// buffer.
extern "C" int ngp_compact_unpack_bwd(const void* g_sig, const void* g_rgb,
                                      const void* sample_of, long long Mc, void* g_sig_c,
                                      void* g_rgb_c, cudaStream_t s) {
  if (Mc > 0) {
    k5_unpack_bwd<<<(unsigned int)((Mc + UNPACK_TILE - 1) / UNPACK_TILE), THREADS, 0, s>>>(
        (const float*)g_sig, (const float*)g_rgb, (const int*)sample_of, Mc, (float*)g_sig_c,
        (float*)g_rgb_c);
  }
  NGP_RETURN_LAST_ERROR();
}
