// K8: the background sphere's 2D hash encoding, forward and backward, F =
// 1, 2, 4 or 8 features a row.
//
// Replaces nerf_signature_tpu/ops/hashenc.py:_hash_encode_2d_impl (4-corner
// bilinear interpolation with the 2D XOR-of-primes hash, every level hashed,
// level l's rows at l << log2_size) and its input,
// nerf_signature_tpu/ops/intersect.py:sph_from_ray: the far root of
// |o + t d|^2 = r^2 (the discriminant clamped at 0), the exit point's
// (theta, phi) by atan2 over pi, mapped to [-1, 1] and then to (sph + 1) / 2.
// The sphere point is computed here from rays_o and rays_d, in the forward
// and again in the backward, so no [N, 2] tensor goes through memory; a
// caller that has the 2D positions already (x01) passes them instead.  The
// file is compiled with -fmad=false and writes each product and sum in the
// JAX order; atan2f and the division differ from XLA's by ulps, so the
// features match JAX's to an absolute tolerance (they are continuous in the
// position), except at phi's branch cut (a ray whose exit point lies on the
// -x half-plane y = 0), where phi = +-1 may fall either way.
//
// Design: one thread a ray, the levels in a loop (4 at the defaults), four
// corner rows a level from the table in the gather dtype (4 x 2^15 rows of 2
// bf16 at the defaults: 512 KB, L2-resident).  Forward: L*F fp32 features a
// ray, written as F-wide stores.  Backward: the fp32 gradient of the master
// table, each corner's contribution cw * g rounded to bf16 first under a
// bf16 gather (JAX's _make_gather_rows cotangent, as in K1); at levels whose
// bit is set in ``combine`` the warp's adds into one row are grouped
// (__match_any_sync, reduce_peers, one vector atomic a group: neighbouring
// rays exit the sphere at neighbouring cells), elsewhere one vector atomic
// a lane.  Bound on the H100: bytes (24 B of rays read, L*F*4 B of features
// written a ray; the backward reads the cotangent and writes the table's
// gradient).  The background MLP that reads these features runs once a ray,
// outside any kernel, as in JAX (models/ngp.py:ngp_background).

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

// The 4 corners of one (ray, level): rows (level offset added) and bilinear
// weights, in the JAX corner order ((0,0), (0,1), (1,0), (1,1)).
__device__ __forceinline__ void corners_2d(const float (&xc)[2], float res, unsigned int mask,
                                           unsigned int off, unsigned int (&idx)[4],
                                           float (&cw)[4]) {
  float w[2];
  unsigned int cell[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float s = __fmul_rn(xc[a], res);
    const float f = floorf(s);
    w[a] = __fsub_rn(s, f);
    cell[a] = (unsigned int)f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned int di = (c >> 1) & 1u, dj = c & 1u;
    idx[c] = ((((cell[0] + di) * 1u) ^ ((cell[1] + dj) * 2654435761u)) & mask) + off;
    const float wx = di ? w[0] : __fsub_rn(1.0f, w[0]);
    const float wy = dj ? w[1] : __fsub_rn(1.0f, w[1]);
    cw[c] = __fmul_rn(wx, wy);
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(128)
    hash2d_fwd(BgInput in, const T* __restrict__ table, float* __restrict__ out, long long N,
               HashLevels p) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float x[2];
  bg_position(in, n, x);
  const float xc[2] = {ngp_clip(x[0], 0.0f, 1.0f), ngp_clip(x[1], 0.0f, 1.0f)};
  const unsigned int mask = (1u << p.log2_size) - 1u;
  float* dst = out + n * p.L * F;
  for (int l = 0; l < p.L; ++l) {
    unsigned int idx[4];
    float cw[4];
    corners_2d(xc, p.res[l], mask, p.offset[l], idx, cw);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float r[F];
      load_row<F>(table, idx[c], r);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(cw[c], r[f]));
    }
    store_f<F>(dst + l * F, acc);
  }
}

template <int F>
__global__ void __launch_bounds__(128)
    hash2d_bwd(BgInput in, const float* __restrict__ g_feat, float* __restrict__ g_table,
               long long N, HashLevels p, int round_bf16, unsigned int combine) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < N;  // every lane stays: the grouped adds take the whole warp
  const int lane = threadIdx.x & 31;
  float xc[2] = {0.0f, 0.0f};
  if (live) {
    float x[2];
    bg_position(in, n, x);
    xc[0] = ngp_clip(x[0], 0.0f, 1.0f);
    xc[1] = ngp_clip(x[1], 0.0f, 1.0f);
  }
  const unsigned int mask = (1u << p.log2_size) - 1u;
  for (int l = 0; l < p.L; ++l) {
    float g[F];
    bool hot = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      g[f] = live ? g_feat[n * p.L * F + l * F + f] : 0.0f;
      hot = hot || g[f] != 0.0f;
    }
    if (!__any_sync(NGP_FULL, hot)) continue;  // 32 zero cotangents
    unsigned int idx[4];
    float cw[4];
    corners_2d(xc, p.res[l], mask, p.offset[l], idx, cw);
    const bool grouped = (combine >> l) & 1u;  // the same for the whole warp
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[F];
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v[f] = __fmul_rn(cw[c], g[f]);
        if (round_bf16) v[f] = __bfloat162float(__float2bfloat16_rn(v[f]));
        any = any || v[f] != 0.0f;
      }
      warp_add<F>(g_table, idx[c], v, any, grouped, lane);
    }
  }
}

static int bg_levels(HashLevels& p, int L, const float* res, int log2_size) {
  unsigned int off[NGP_MAX_LEVELS], side[NGP_MAX_LEVELS];
  if (L < 1 || L > NGP_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    off[l] = (unsigned int)l << log2_size;
    side[l] = 0u;
  }
  return fill_levels(p, L, res, off, side, log2_size);
}

template <typename T, int F>
static int launch_2d_fwd(const BgInput& in, const void* table, void* out, long long N,
                         const HashLevels& p, cudaStream_t s) {
  hash2d_fwd<T, F><<<ngp_blocks(N, 128), 128, 0, s>>>(in, (const T*)table, (float*)out, N, p);
  NGP_RETURN_LAST_ERROR();
}

template <typename T>
static int dispatch_2d_fwd(int F, const BgInput& in, const void* table, void* out, long long N,
                           const HashLevels& p, cudaStream_t s) {
  switch (F) {
    case 1: return launch_2d_fwd<T, 1>(in, table, out, N, p, s);
    case 2: return launch_2d_fwd<T, 2>(in, table, out, N, p, s);
    case 4: return launch_2d_fwd<T, 4>(in, table, out, N, p, s);
    case 8: return launch_2d_fwd<T, 8>(in, table, out, N, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x01 [N, 2] or null (then rays_o, rays_d [N, 3] and r2); table [L << log2,
// F] in bf16 (table_bf16) or fp32; out [N, L*F] fp32.
extern "C" int ngp_hash_encode_2d(const void* x01, const void* rays_o, const void* rays_d,
                                  float r2, const void* table, int table_bf16, int F, void* out,
                                  long long N, int L, const float* res, int log2_size,
                                  void* stream) {
  HashLevels p;
  const int rc = bg_levels(p, L, res, log2_size);
  if (rc != 0) return rc;
  if (F != 1 && F != 2 && F != 4 && F != 8) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const BgInput in{(const float*)x01, (const float*)rays_o, (const float*)rays_d, r2};
  cudaStream_t s = (cudaStream_t)stream;
  return table_bf16 ? dispatch_2d_fwd<__nv_bfloat16>(F, in, table, out, N, p, s)
                    : dispatch_2d_fwd<float>(F, in, table, out, N, p, s);
}

template <int F>
static int launch_2d_bwd(const BgInput& in, const void* g_feat, void* g_table, long long N,
                         const HashLevels& p, int round_bf16, unsigned int combine,
                         cudaStream_t s) {
  hash2d_bwd<F><<<ngp_blocks(N, 128), 128, 0, s>>>(in, (const float*)g_feat, (float*)g_table,
                                                    N, p, round_bf16, combine);
  NGP_RETURN_LAST_ERROR();
}

// g_feat [N, L*F] fp32; g_table [L << log2, F] fp32, zeroed, 16-byte
// aligned.  combine: bit l set where level l's adds are grouped by row.
extern "C" int ngp_hash_encode_2d_bwd(const void* x01, const void* rays_o, const void* rays_d,
                                      float r2, const void* g_feat, int round_bf16, int F,
                                      void* g_table, long long N, int L, const float* res,
                                      int log2_size, unsigned int combine, void* stream) {
  HashLevels p;
  const int rc = bg_levels(p, L, res, log2_size);
  if (rc != 0) return rc;
  if (N == 0) return 0;
  const BgInput in{(const float*)x01, (const float*)rays_o, (const float*)rays_d, r2};
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch_2d_bwd<1>(in, g_feat, g_table, N, p, round_bf16, combine, s);
    case 2: return launch_2d_bwd<2>(in, g_feat, g_table, N, p, round_bf16, combine, s);
    case 4: return launch_2d_bwd<4>(in, g_feat, g_table, N, p, round_bf16, combine, s);
    case 8: return launch_2d_bwd<8>(in, g_feat, g_table, N, p, round_bf16, combine, s);
  }
  return (int)cudaErrorInvalidValue;
}
