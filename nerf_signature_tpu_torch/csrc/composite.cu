// K3: front-to-back compositing, forward and backward.
//
// Replaces nerf_signature_tpu/ops/composite.py:composite_rays (the closed
// form tau = sigma*dt, T_in = exp(-(cumsum(tau) - tau)),
// w = (1 - exp(-tau)) * T_in, zero where T_in < T_thresh or masked) and,
// in composite_bwd below, JAX's autodiff of that closed form.
//
// What bounds it on the H100: memory.  Of the slots before a ray's stop it
// needs the mask byte, and of the live ones among them sigma, delta, t and
// three colours (24 B); it writes every slot's weight (4 B) and 20 B a ray
// of image, depth and weight sum.  The arithmetic is two exps a live slot.
//
// Design: one warp a ray, RAYS rays a block, the slots in chunks of 32 with
// lane = slot, so every load and store of a chunk is one coalesced
// instruction: sigma, delta and the mask byte (the next chunk's are loaded
// ahead, while this chunk's sums run), t, and the chunk's 96 contiguous
// colour floats as 3 loads regrouped through the warp's shared buffer.
// - The inclusive sum cum_i = cum_{i-1} + tau_i is taken slot by slot in
//   slot order (a serial chain of shuffles, carried from chunk to chunk),
//   so it rounds exactly as a sequential loop does; T_in = exp(-(cum_i -
//   tau_i)) is then lane-wise.  cum, T_in and every weight are bit for bit
//   those of the one-thread-a-ray walk: a parallel scan would move T_in by
//   ulps, and a slot whose T_in sits at T_thresh would flip.
// - T is non-increasing along the ray, so once the entering T falls below
//   T_thresh every later weight is zero: the first such lane is found by a
//   ballot, the warp stops after that chunk (of the rest of the row it has
//   read only the next chunk's sigma, delta and mask, loaded ahead) and
//   zero-fills the rest of the row with coalesced stores.
// - weights_sum, depth and image are per-lane sums over the chunks, then a
//   warp's xor tree: fp32 reordering of the sequential sums.
// Compiled with -fmad=false so every product rounds like the plain version.

#include "common.cuh"

namespace {

constexpr int RAYS = 4;  // rays (warps) a block
constexpr unsigned FULL = 0xffffffffu;

// One lane's slot of a chunk: sigma and delta are read only for live slots.
struct Slot {
  float sigma, delta;
  bool live;
};

__device__ __forceinline__ Slot load_slot(const float* __restrict__ sigmas,
                                          const float* __restrict__ deltas,
                                          const unsigned char* __restrict__ mask, long long k,
                                          bool valid) {
  Slot s;
  s.live = valid && (mask == nullptr || mask[k] != 0);
  s.sigma = s.live ? sigmas[k] : 0.0f;
  s.delta = s.live ? deltas[k] : 0.0f;
  return s;
}

// carry + tau_0 + ... + tau_lane, added one slot at a time in slot order;
// carry becomes the chunk's last sum.  Every lane runs the same chain.  A
// chunk with no live slot adds only zeros, and its callers skip the chain.
__device__ __forceinline__ float serial_cumsum(float& carry, float tau, int lane) {
  float c = carry, mine = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    c = __fadd_rn(c, __shfl_sync(FULL, tau, j));
    mine = lane == j ? c : mine;
  }
  carry = c;
  return mine;
}

// The warp's sum, by an xor tree (every lane gets the same bits).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// Inclusive prefix sum over the lanes (Hillis-Steele).
__device__ __forceinline__ float inclusive_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = __fadd_rn(y, v);
  }
  return v;
}

// Lanes before the first set bit of stop (all lanes if none is set).
__device__ __forceinline__ unsigned lanes_before(unsigned stop) {
  return stop ? (1u << (__ffs(stop) - 1)) - 1u : FULL;
}

// The chunk's colours: n3 floats from src in 3 coalesced loads (a float is
// read only if its slot's bit is set in want, else 0), regrouped so that
// each lane holds its own slot's three.
__device__ __forceinline__ void load_rgb(const float* __restrict__ src, int n3, unsigned want,
                                         float* buf, int lane, float (&c)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int e = q * 32 + lane;
    buf[e] = (e < n3 && ((want >> (e / 3)) & 1u)) ? src[e] : 0.0f;
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 3; ++q) c[q] = buf[3 * lane + q];
  __syncwarp();
}

// The reverse: each lane's three values out as n3 contiguous floats.
__device__ __forceinline__ void store_rgb(float* __restrict__ dst, int n3, const float (&c)[3],
                                          float* buf, int lane) {
#pragma unroll
  for (int q = 0; q < 3; ++q) buf[3 * lane + q] = c[q];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int e = q * 32 + lane;
    if (e < n3) dst[e] = buf[e];
  }
  __syncwarp();
}

// One chunk of a ray's walk, the same in the forward and both backward
// passes: this chunk's tau (0 unless live), its entering T (cum carried
// from the last chunk), the lanes kept (live and before the ray's stop, the
// first slot whose entering T is below T_thresh: it and every later slot
// get no weight) and, if any is kept, their colours.  The forward and the
// backward's first pass find the stop by a ballot (stop: its bit, if it
// lies in this chunk); the second pass knows it (stop_at) and so issues the
// colour loads before the serial chain.
struct Chunk {
  float tau, T_in, c[3];
  unsigned stop;
  bool keep;
};

template <bool KNOWN_STOP>
__device__ __forceinline__ Chunk walk_chunk(const Slot& cur, float& cum,
                                            const float* __restrict__ rgbs, long long base,
                                            int c0, int S, float T_thresh, int stop_at,
                                            float* buf, int lane) {
  Chunk ch;
  ch.c[0] = ch.c[1] = ch.c[2] = 0.0f;
  ch.stop = 0u;
  ch.tau = cur.live ? __fmul_rn(cur.sigma, cur.delta) : 0.0f;
  if (KNOWN_STOP) {
    ch.keep = cur.live && c0 + lane < stop_at;
    const unsigned want = __ballot_sync(FULL, ch.keep);
    if (want) load_rgb(rgbs + 3 * (base + c0), 3 * min(32, S - c0), want, buf, lane, ch.c);
  }
  const float cum_i = __any_sync(FULL, cur.live) ? serial_cumsum(cum, ch.tau, lane) : cum;
  ch.T_in = expf(-__fsub_rn(cum_i, ch.tau));
  if (!KNOWN_STOP) {
    ch.stop = __ballot_sync(FULL, c0 + lane < S && !(ch.T_in >= T_thresh));
    ch.keep = cur.live && ((lanes_before(ch.stop) >> lane) & 1u);
    const unsigned want = __ballot_sync(FULL, ch.keep);
    if (want) load_rgb(rgbs + 3 * (base + c0), 3 * min(32, S - c0), want, buf, lane, ch.c);
  }
  return ch;
}

__global__ void __launch_bounds__(32 * RAYS)
    composite_fwd(const float* __restrict__ sigmas, const float* __restrict__ rgbs,
                  const float* __restrict__ deltas, const float* __restrict__ ts,
                  const unsigned char* __restrict__ mask, float T_thresh, int N, int S,
                  float* __restrict__ weights_sum, float* __restrict__ depth,
                  float* __restrict__ image, float* __restrict__ weights) {
  __shared__ float rgb_buf[RAYS][96];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * RAYS + warp;
  if (n >= N) return;
  const long long base = (long long)n * S;
  float* buf = rgb_buf[warp];
  float cum = 0.0f, ws = 0.0f, dep = 0.0f, col[3] = {0.0f, 0.0f, 0.0f};
  Slot cur = load_slot(sigmas, deltas, mask, base + lane, lane < S);
  int c0 = 0;
  while (c0 < S) {
    const long long k = base + c0 + lane;
    const Slot nxt = load_slot(sigmas, deltas, mask, k + 32, c0 + 32 + lane < S);
    const Chunk ch = walk_chunk<false>(cur, cum, rgbs, base, c0, S, T_thresh, S, buf, lane);
    float w = 0.0f;
    if (ch.keep) {
      w = __fmul_rn(__fsub_rn(1.0f, expf(-ch.tau)), ch.T_in);
      ws = __fadd_rn(ws, w);
      dep = __fadd_rn(dep, __fmul_rn(w, ts[k]));
#pragma unroll
      for (int q = 0; q < 3; ++q) col[q] = __fadd_rn(col[q], __fmul_rn(w, ch.c[q]));
    }
    if (c0 + lane < S) weights[k] = w;
    c0 += 32;
    if (ch.stop) break;
    cur = nxt;
  }
  for (int i = c0 + lane; i < S; i += 32) weights[base + i] = 0.0f;
  ws = warp_sum(ws);
  dep = warp_sum(dep);
#pragma unroll
  for (int q = 0; q < 3; ++q) col[q] = warp_sum(col[q]);
  if (lane == 0) {
    weights_sum[n] = ws;
    depth[n] = dep;
    image[n * 3 + 0] = col[0];
    image[n * 3 + 1] = col[1];
    image[n * 3 + 2] = col[2];
  }
}

// K3 backward: d sigmas [N, S] and d rgbs [N, S, 3] from the cotangents of
// weights_sum, depth, image (and weights), each optional (NULL = zero).
//
// The analytic form of JAX's autodiff of the closed form.  With
// e_i = g_w_i + g_img . rgb_i + g_ws + g_depth * t_i on live samples:
//   dL/dtau_k   = e_k * exp(-tau_k) * T_in_k - sum_{i > k, live} w_i * e_i
//   dL/dsigma_k = dL/dtau_k * delta_k on unmasked samples, 0 on masked ones
//   dL/drgb_i   = w_i * g_img
// T_in_i = exp(-(cum_i - tau_i)) has an exactly zero derivative in tau_i
// under autodiff (cum_i - tau_i only holds tau_j for j < i), so no tau_k
// term of T_in_k appears above.
//
// What bounds it on the H100: memory, like the forward.  It needs the
// forward's inputs (the second pass finds them in L2) and 20 B a ray of
// cotangents, and writes 16 B of gradients for every slot (zeros past the
// stop and on masked slots).
//
// Design: the forward's layout (a warp a ray, chunks of 32, lane = slot,
// coalesced loads and stores, the serial chain for cum, the ballot stop), in
// two passes, each a walk of the forward's chunks (walk_chunk) up to the
// stop.  Pass 1 finds the stop and sums R = sum_live w_i e_i (per lane,
// then the xor tree).  Pass 2, which knows the stop, takes the prefix P_k
// of w_i e_i by a warp scan carried from chunk to chunk, and writes the
// gradients with the suffix sum as R - P_k; masked slots and slots past
// the stop get zeros.  No atomics: repeats are bit-equal.
__global__ void __launch_bounds__(32 * RAYS)
    composite_bwd(const float* __restrict__ sigmas, const float* __restrict__ rgbs,
                  const float* __restrict__ deltas, const float* __restrict__ ts,
                  const unsigned char* __restrict__ mask, float T_thresh, int N, int S,
                  const float* __restrict__ g_ws, const float* __restrict__ g_depth,
                  const float* __restrict__ g_image, const float* __restrict__ g_weights,
                  float* __restrict__ g_sigmas, float* __restrict__ g_rgbs) {
  __shared__ float rgb_buf[RAYS][96];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * RAYS + warp;
  if (n >= N) return;
  const long long base = (long long)n * S;
  float* buf = rgb_buf[warp];
  const float gws = g_ws ? g_ws[n] : 0.0f;
  const float gd = g_depth ? g_depth[n] : 0.0f;
  float gc[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) gc[q] = g_image ? g_image[n * 3 + q] : 0.0f;

  // e of a live slot k with colours c, in the one-thread walk's order
  auto slot_e = [&](const float (&c)[3], long long k) {
    float e = __fadd_rn(__fadd_rn(__fmul_rn(gc[0], c[0]), __fmul_rn(gc[1], c[1])),
                        __fmul_rn(gc[2], c[2]));
    e = __fadd_rn(__fadd_rn(e, gws), __fmul_rn(gd, ts[k]));
    return g_weights ? __fadd_rn(e, g_weights[k]) : e;
  };

  // pass 1: the forward's walk, summing w_i * e_i over the kept slots; stop
  // = the first slot whose entering T is below T_thresh (S if none)
  float cum = 0.0f, r_lane = 0.0f;
  int stop = S;
  Slot cur = load_slot(sigmas, deltas, mask, base + lane, lane < S);
  for (int c0 = 0; c0 < S; c0 += 32) {
    const long long k = base + c0 + lane;
    const Slot nxt = load_slot(sigmas, deltas, mask, k + 32, c0 + 32 + lane < S);
    const Chunk ch = walk_chunk<false>(cur, cum, rgbs, base, c0, S, T_thresh, S, buf, lane);
    if (ch.keep) {
      const float w = __fmul_rn(__fsub_rn(1.0f, expf(-ch.tau)), ch.T_in);
      r_lane = __fadd_rn(r_lane, __fmul_rn(w, slot_e(ch.c, k)));
    }
    if (ch.stop) {
      stop = c0 + __ffs(ch.stop) - 1;
      break;
    }
    cur = nxt;
  }
  const float R = warp_sum(r_lane);

  // pass 2: the same walk up to the stop, the gradients of the kept slots
  // with the suffix sum as R - prefix, zeros elsewhere
  cum = 0.0f;
  float P = 0.0f;
  int c0 = 0;
  cur = load_slot(sigmas, deltas, mask, base + lane, lane < stop);
  for (; c0 < stop; c0 += 32) {
    const long long k = base + c0 + lane;
    const Slot nxt = load_slot(sigmas, deltas, mask, k + 32, c0 + 32 + lane < stop);
    const Chunk ch = walk_chunk<true>(cur, cum, rgbs, base, c0, S, T_thresh, stop, buf, lane);
    float gs = 0.0f, gr[3] = {0.0f, 0.0f, 0.0f};
    if (__any_sync(FULL, ch.keep)) {
      float w = 0.0f, e = 0.0f, e_tau = 0.0f;
      if (ch.keep) {
        e_tau = expf(-ch.tau);
        w = __fmul_rn(__fsub_rn(1.0f, e_tau), ch.T_in);
        e = slot_e(ch.c, k);
      }
      const float Pk = __fadd_rn(P, inclusive_scan(ch.keep ? __fmul_rn(w, e) : 0.0f, lane));
      P = __shfl_sync(FULL, Pk, 31);
      if (ch.keep) {
        const float dtau = __fsub_rn(__fmul_rn(__fmul_rn(e, e_tau), ch.T_in), __fsub_rn(R, Pk));
        gs = __fmul_rn(dtau, cur.delta);
#pragma unroll
        for (int q = 0; q < 3; ++q) gr[q] = __fmul_rn(w, gc[q]);
      }
    }
    if (c0 + lane < S) g_sigmas[k] = gs;
    store_rgb(g_rgbs + 3 * (base + c0), 3 * min(32, S - c0), gr, buf, lane);
    cur = nxt;
  }
  for (int i = c0 + lane; i < S; i += 32) g_sigmas[base + i] = 0.0f;
  for (long long e = 3LL * c0 + lane; e < 3LL * S; e += 32) g_rgbs[3 * base + e] = 0.0f;
}

}  // namespace

extern "C" int ngp_composite(const void* sigmas, const void* rgbs, const void* deltas,
                             const void* ts, const void* mask, float T_thresh, int N, int S,
                             void* weights_sum, void* depth, void* image, void* weights,
                             void* stream) {
  if (N == 0) return 0;
  composite_fwd<<<ngp_blocks(N, RAYS), 32 * RAYS, 0, (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)rgbs, (const float*)deltas, (const float*)ts,
      (const unsigned char*)mask, T_thresh, N, S, (float*)weights_sum, (float*)depth,
      (float*)image, (float*)weights);
  NGP_RETURN_LAST_ERROR();
}

extern "C" int ngp_composite_bwd(const void* sigmas, const void* rgbs, const void* deltas,
                                 const void* ts, const void* mask, float T_thresh, int N, int S,
                                 const void* g_ws, const void* g_depth, const void* g_image,
                                 const void* g_weights, void* g_sigmas, void* g_rgbs,
                                 void* stream) {
  if (N == 0) return 0;
  composite_bwd<<<ngp_blocks(N, RAYS), 32 * RAYS, 0, (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)rgbs, (const float*)deltas, (const float*)ts,
      (const unsigned char*)mask, T_thresh, N, S, (const float*)g_ws, (const float*)g_depth,
      (const float*)g_image, (const float*)g_weights, (float*)g_sigmas, (float*)g_rgbs);
  NGP_RETURN_LAST_ERROR();
}
