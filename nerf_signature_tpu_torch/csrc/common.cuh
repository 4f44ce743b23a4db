// Shared helpers for the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NGP_RETURN_LAST_ERROR() return (int)cudaGetLastError()

static inline unsigned int ngp_blocks(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

// jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi)
__device__ __forceinline__ float ngp_clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
