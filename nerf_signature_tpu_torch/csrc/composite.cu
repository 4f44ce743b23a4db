// K3: front-to-back compositing, forward.
//
// Replaces nerf_signature_tpu/ops/composite.py:composite_rays (the closed
// form tau = sigma*dt, T_in = exp(-(cumsum(tau) - tau)),
// w = (1 - exp(-tau)) * T_in, zero where T_in < T_thresh or masked).
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
