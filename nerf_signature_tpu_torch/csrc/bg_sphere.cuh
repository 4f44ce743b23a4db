// The background sphere's shared device code: K8's 2D encoding
// (hashenc_bg.cu) and the whole background colour (background.cu).  The
// exit point of a ray on the sphere as sph_from_ray computes it, the four
// corners of a level in the JAX order and with its roundings (every file
// that includes this is compiled with -fmad=false), and the level
// parameters (every level hashed, level l's rows at l << log2_size).
#pragma once

#include "hashenc.cuh"

struct BgInput {
  const float* x01;     // [N, 2] positions in [0, 1]^2, or null: from the rays
  const float* rays_o;  // [N, 3]
  const float* rays_d;  // [N, 3]
  float r2;             // the sphere's radius squared (fp32, as JAX rounds it)
};

// sph_from_ray's exit point as (theta, phi) in [-1, 1], then (sph + 1) / 2,
// each operation rounded where JAX rounds it
__device__ __forceinline__ void bg_position(const BgInput& in, long long n, float (&x)[2]) {
  if (in.x01 != nullptr) {
    x[0] = in.x01[2 * n];
    x[1] = in.x01[2 * n + 1];
    return;
  }
  const float* o = in.rays_o + 3 * n;
  const float* d = in.rays_d + 3 * n;
  const float ox = o[0], oy = o[1], oz = o[2], dx = d[0], dy = d[1], dz = d[2];
  const float a = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  const float b = __fmul_rn(
      2.0f, __fadd_rn(__fadd_rn(__fmul_rn(ox, dx), __fmul_rn(oy, dy)), __fmul_rn(oz, dz)));
  const float c = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)), __fmul_rn(oz, oz)), in.r2);
  const float disc = fmaxf(__fsub_rn(__fmul_rn(b, b), __fmul_rn(__fmul_rn(4.0f, a), c)), 0.0f);
  const float t = __fdiv_rn(__fadd_rn(-b, __fsqrt_rn(disc)), __fmul_rn(2.0f, a));
  const float px = __fadd_rn(ox, __fmul_rn(t, dx));
  const float py = __fadd_rn(oy, __fmul_rn(t, dy));
  const float pz = __fadd_rn(oz, __fmul_rn(t, dz));
  const float pi = 3.14159265358979f;
  const float theta =
      __fdiv_rn(atan2f(__fsqrt_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py))), pz), pi);
  const float phi = __fdiv_rn(atan2f(py, px), pi);
  x[0] = __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(2.0f, theta), 1.0f), 1.0f), 0.5f);
  x[1] = __fmul_rn(__fadd_rn(phi, 1.0f), 0.5f);
}

// The cell of one (ray, level) at resolution res: its lower corner and the
// bilinear fractions, rounded where JAX rounds them.
struct Cell2d {
  unsigned int c[2];
  float w[2];
};

__device__ __forceinline__ Cell2d cell_2d(const float (&xc)[2], float res) {
  Cell2d q;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float s = __fmul_rn(xc[a], res);
    const float f = floorf(s);
    q.w[a] = __fsub_rn(s, f);
    q.c[a] = (unsigned int)f;
  }
  return q;
}

// Corner c of a cell, in the JAX corner order ((0,0), (0,1), (1,0), (1,1)):
// its row (level offset added) and bilinear weight.
__device__ __forceinline__ void corner_2d(const Cell2d& q, int c, unsigned int mask,
                                          unsigned int off, unsigned int& idx, float& cw) {
  const unsigned int di = (c >> 1) & 1u, dj = c & 1u;
  idx = ((((q.c[0] + di) * 1u) ^ ((q.c[1] + dj) * 2654435761u)) & mask) + off;
  const float wx = di ? q.w[0] : __fsub_rn(1.0f, q.w[0]);
  const float wy = dj ? q.w[1] : __fsub_rn(1.0f, q.w[1]);
  cw = __fmul_rn(wx, wy);
}

// The 4 corners of one (ray, level): rows and bilinear weights.
__device__ __forceinline__ void corners_2d(const float (&xc)[2], float res, unsigned int mask,
                                           unsigned int off, unsigned int (&idx)[4],
                                           float (&cw)[4]) {
  const Cell2d q = cell_2d(xc, res);
#pragma unroll
  for (int c = 0; c < 4; ++c) corner_2d(q, c, mask, off, idx[c], cw[c]);
}

static inline int bg_levels(HashLevels& p, int L, const float* res, int log2_size) {
  unsigned int off[NGP_MAX_LEVELS], side[NGP_MAX_LEVELS];
  if (L < 1 || L > NGP_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    off[l] = (unsigned int)l << log2_size;
    side[l] = 0u;
  }
  return fill_levels(p, L, res, off, side, log2_size);
}

