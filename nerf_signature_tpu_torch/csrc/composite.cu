// K3: front-to-back compositing, forward and backward.
//
// Replaces nerf_signature_tpu/ops/composite.py:composite_rays (the closed
// form tau = sigma*dt, T_in = exp(-(cumsum(tau) - tau)),
// w = (1 - exp(-tau)) * T_in, zero where T_in < T_thresh or masked) and,
// in composite_bwd below, JAX's autodiff of that closed form.
//
// What bounds it on the H100: memory.  Per slot it reads sigma, delta, t,
// three colours and the mask (25 B) and writes the weight (4 B); per ray it
// writes 20 B of image, depth and weight sum.  The arithmetic is two exps a
// slot.
//
// Design: one thread per ray, sequential over the S slots, carrying the
// inclusive cumulative sum exactly as the JAX formula writes it (T_in is
// recomputed as exp(-(cum - tau)), not multiplied up).  T is non-increasing
// along the ray, so once the entering T falls below T_thresh every later
// weight is zero: the thread stops reading there and writes zeros for the
// rest of the row.  Compiled with -fmad=false so every product rounds like
// the plain version.

#include "common.cuh"

__global__ void composite_fwd(const float* __restrict__ sigmas, const float* __restrict__ rgbs,
                              const float* __restrict__ deltas, const float* __restrict__ ts,
                              const unsigned char* __restrict__ mask, float T_thresh, int N,
                              int S, float* __restrict__ weights_sum, float* __restrict__ depth,
                              float* __restrict__ image, float* __restrict__ weights) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long base = (long long)n * S;
  float cum = 0.0f, ws = 0.0f, dep = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int i = 0;
  for (; i < S; ++i) {
    const long long k = base + i;
    const bool live_slot = (mask == nullptr) || mask[k];
    const float tau = live_slot ? __fmul_rn(sigmas[k], deltas[k]) : 0.0f;
    const float cum_i = __fadd_rn(cum, tau);
    const float T_in = expf(-__fsub_rn(cum_i, tau));
    if (!(T_in >= T_thresh)) break;
    cum = cum_i;
    float w = live_slot ? __fmul_rn(__fsub_rn(1.0f, expf(-tau)), T_in) : 0.0f;
    weights[k] = w;
    ws = __fadd_rn(ws, w);
    dep = __fadd_rn(dep, __fmul_rn(w, ts[k]));
    r = __fadd_rn(r, __fmul_rn(w, rgbs[k * 3 + 0]));
    g = __fadd_rn(g, __fmul_rn(w, rgbs[k * 3 + 1]));
    b = __fadd_rn(b, __fmul_rn(w, rgbs[k * 3 + 2]));
  }
  for (; i < S; ++i) weights[base + i] = 0.0f;
  weights_sum[n] = ws;
  depth[n] = dep;
  image[n * 3 + 0] = r;
  image[n * 3 + 1] = g;
  image[n * 3 + 2] = b;
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
// What bounds it on the H100: memory, like the forward.  Per slot read
// before termination it reads sigma, delta, t, three colours and the mask
// (25 B, twice) and writes 16 B of gradients; slots past termination are
// only written (zeros).
//
// Design: one thread per ray, replaying the forward's loop exactly (same
// roundings, same stop at the first slot whose entering T falls below
// T_thresh).  Pass 1 sums R = sum_{live} w_i e_i; pass 2 walks again and
// takes the suffix sum as R minus the running prefix.  One thread per ray
// leaves a warp's loads uncoalesced (rows are S*4 bytes apart), as in the
// forward; a warp per ray is the later speed step.
__global__ void composite_bwd(const float* __restrict__ sigmas, const float* __restrict__ rgbs,
                              const float* __restrict__ deltas, const float* __restrict__ ts,
                              const unsigned char* __restrict__ mask, float T_thresh, int N,
                              int S, const float* __restrict__ g_ws,
                              const float* __restrict__ g_depth,
                              const float* __restrict__ g_image,
                              const float* __restrict__ g_weights, float* __restrict__ g_sigmas,
                              float* __restrict__ g_rgbs) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long base = (long long)n * S;
  const float gws = g_ws ? g_ws[n] : 0.0f;
  const float gd = g_depth ? g_depth[n] : 0.0f;
  const float gr = g_image ? g_image[n * 3 + 0] : 0.0f;
  const float gg = g_image ? g_image[n * 3 + 1] : 0.0f;
  const float gb = g_image ? g_image[n * 3 + 2] : 0.0f;

  auto slot_e = [&](long long k) {
    float e = __fadd_rn(__fadd_rn(__fmul_rn(gr, rgbs[k * 3 + 0]), __fmul_rn(gg, rgbs[k * 3 + 1])),
                        __fmul_rn(gb, rgbs[k * 3 + 2]));
    e = __fadd_rn(__fadd_rn(e, gws), __fmul_rn(gd, ts[k]));
    return g_weights ? __fadd_rn(e, g_weights[k]) : e;
  };

  // pass 1: the forward's walk, summing w_i * e_i
  float cum = 0.0f, R = 0.0f;
  int stop = 0;
  for (; stop < S; ++stop) {
    const long long k = base + stop;
    const bool live_slot = (mask == nullptr) || mask[k];
    const float tau = live_slot ? __fmul_rn(sigmas[k], deltas[k]) : 0.0f;
    const float cum_i = __fadd_rn(cum, tau);
    const float T_in = expf(-__fsub_rn(cum_i, tau));
    if (!(T_in >= T_thresh)) break;
    cum = cum_i;
    if (!live_slot) continue;
    const float w = __fmul_rn(__fsub_rn(1.0f, expf(-tau)), T_in);
    R = __fadd_rn(R, __fmul_rn(w, slot_e(k)));
  }

  // pass 2: the gradients, with the suffix sum R - prefix
  cum = 0.0f;
  float P = 0.0f;
  int i = 0;
  for (; i < stop; ++i) {
    const long long k = base + i;
    if (!((mask == nullptr) || mask[k])) {  // masked: tau = 0, cum unchanged
      g_sigmas[k] = 0.0f;
      g_rgbs[k * 3 + 0] = g_rgbs[k * 3 + 1] = g_rgbs[k * 3 + 2] = 0.0f;
      continue;
    }
    const float delta = deltas[k];
    const float tau = __fmul_rn(sigmas[k], delta);
    const float cum_i = __fadd_rn(cum, tau);
    const float T_in = expf(-__fsub_rn(cum_i, tau));
    cum = cum_i;
    const float e_tau = expf(-tau);
    const float w = __fmul_rn(__fsub_rn(1.0f, e_tau), T_in);
    const float e = slot_e(k);
    P = __fadd_rn(P, __fmul_rn(w, e));
    const float dtau = __fsub_rn(__fmul_rn(__fmul_rn(e, e_tau), T_in), __fsub_rn(R, P));
    g_sigmas[k] = __fmul_rn(dtau, delta);
    g_rgbs[k * 3 + 0] = __fmul_rn(w, gr);
    g_rgbs[k * 3 + 1] = __fmul_rn(w, gg);
    g_rgbs[k * 3 + 2] = __fmul_rn(w, gb);
  }
  for (; i < S; ++i) {
    const long long k = base + i;
    g_sigmas[k] = 0.0f;
    g_rgbs[k * 3 + 0] = g_rgbs[k * 3 + 1] = g_rgbs[k * 3 + 2] = 0.0f;
  }
}

extern "C" int ngp_composite(const void* sigmas, const void* rgbs, const void* deltas,
                             const void* ts, const void* mask, float T_thresh, int N, int S,
                             void* weights_sum, void* depth, void* image, void* weights,
                             void* stream) {
  if (N == 0) return 0;
  const int threads = 128;
  composite_fwd<<<ngp_blocks(N, threads), threads, 0, (cudaStream_t)stream>>>(
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
  const int threads = 128;
  composite_bwd<<<ngp_blocks(N, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)rgbs, (const float*)deltas, (const float*)ts,
      (const unsigned char*)mask, T_thresh, N, S, (const float*)g_ws, (const float*)g_depth,
      (const float*)g_image, (const float*)g_weights, (float*)g_sigmas, (float*)g_rgbs);
  NGP_RETURN_LAST_ERROR();
}
