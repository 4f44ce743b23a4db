// K2: occupancy-grid ray marcher with the AABB slab test as its prologue.
//
// Replaces nerf_signature_tpu/ops/marching.py:_march_rays_impl (with
// _candidate_ts, _cells_and_levels and _select_first) and
// ops/intersect.py:near_far_from_aabb.  Per ray: near/far from the slab
// test; the candidate walk t_i = t0 + i*dt_min (dt_gamma == 0) or
// t_{i+1} = t_i + clip(t_i*dt_gamma, dt_min, dt_max); the cascade level and
// cell of each candidate; the first S occupied candidates kept in order;
// and the three counts n_occupied, n_occupied_raw and n_groups_occ with
// the JAX semantics.  With the prefilter, the walk goes over groups of
// `group` candidates: the dilated coarse grid is tested at each group's
// midpoint (levels lmid-1..lmid+1 when C > 1), every occupied group is
// counted, and fine candidates are tested only inside the first
// `group_budget` occupied groups.
//
// What bounds it on the H100: latency, not bytes or flops.  Per ray it
// reads 24 B of ray and writes S*(12+4+4+1) B of samples; the grid lookups
// are single bytes from a 2 MB (fine) and a 256 KB (coarse) table that stay
// in L2.  A chunk has only 4096 rays, so the walk is a chain of dependent
// loads on 4096 threads.
//
// Design: one thread per ray.  Candidates past `far` can never be valid
// and t never decreases along the walk, so the walk stops at the first
// candidate (or group start) at or beyond far: that is exact for the
// samples and for all three counts.  It does not stop at S, because the
// counts need the rest of the walk.  Slots past the last kept sample get
// zeros, as marching.py:521-524 writes them.  Position and cell arithmetic
// use __fmul_rn/__fadd_rn/__fdiv_rn (and the file is compiled with
// -fmad=false), so every candidate lands in the same cell as in the plain
// version: a flipped cell at a boundary would change which samples a ray
// keeps.

#include "common.cuh"

#define NGP_MISS 3.4028235e38f
#define NGP_MAX_GROUP 16

struct MarchParams {
  float aabb[6];
  int N, C, H, Hc, n_cand, budget, group, group_budget, prefilter;
  float bound, min_near, dt_min, dt_max, dt_gamma, mip0;
};

// clip(0.5 * (p / mb + 1.0) * H, 0, H - 1).astype(int32)
__device__ __forceinline__ int cell_of(float p, float mb, int H) {
  float v = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(__fdiv_rn(p, mb), 1.0f)), (float)H);
  return (int)ngp_clip(v, 0.0f, (float)(H - 1));
}

// The reference's mip level: max(floor(log2 max|p|) + 1, floor(log2(dt*H/2)) + 1),
// clipped to [0, C - 1].
__device__ __forceinline__ int mip_level(const float* p, float dt, int H, int C) {
  float mx = fmaxf(fabsf(p[0]), fmaxf(fabsf(p[1]), fabsf(p[2])));
  float e_pos = __fadd_rn(floorf(log2f(fmaxf(mx, 1e-30f))), 1.0f);
  float e_dt = __fadd_rn(floorf(log2f(fmaxf(__fmul_rn(__fmul_rn(dt, (float)H), 0.5f), 1e-30f))),
                         1.0f);
  return (int)ngp_clip(fmaxf(e_pos, e_dt), 0.0f, (float)(C - 1));
}

__device__ __forceinline__ float mip_bound(int level, float bound) {
  return fminf(ldexpf(1.0f, level), bound);
}

__device__ __forceinline__ int flat_cell(const float* p, float mb, int H) {
  return (cell_of(p[0], mb, H) * H + cell_of(p[1], mb, H)) * H + cell_of(p[2], mb, H);
}

__device__ __forceinline__ void position(const float* o, const float* d, float t, float bound,
                                         float* p) {
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = ngp_clip(__fadd_rn(o[a], __fmul_rn(t, d[a])), -bound, bound);
}

// Fine-grid occupancy at position p (already clipped) with step dt.
__device__ __forceinline__ bool fine_occupied(const unsigned char* __restrict__ grid,
                                              const MarchParams& q, const float* p, float dt) {
  if (q.C == 1) return grid[flat_cell(p, q.mip0, q.H)] != 0;
  int lv = mip_level(p, dt, q.H, q.C);
  long long idx = (long long)lv * q.H * q.H * q.H + flat_cell(p, mip_bound(lv, q.bound), q.H);
  return grid[idx] != 0;
}

// Dilated coarse-grid occupancy at a group midpoint.
__device__ __forceinline__ bool coarse_occupied(const unsigned char* __restrict__ coarse,
                                                const MarchParams& q, const float* p, float dt) {
  const int Hc = q.Hc;
  if (q.C == 1) return coarse[flat_cell(p, q.mip0, Hc)] != 0;
  const int lmid = mip_level(p, dt, q.H, q.C);
  bool occ = false;
  for (int dl = -1; dl <= 1; ++dl) {
    int lv = min(max(lmid + dl, 0), q.C - 1);
    long long idx = (long long)lv * Hc * Hc * Hc + flat_cell(p, mip_bound(lv, q.bound), Hc);
    occ = occ || (coarse[idx] != 0);
  }
  return occ;
}

__device__ __forceinline__ float next_dt(float t, const MarchParams& q) {
  return ngp_clip(__fmul_rn(t, q.dt_gamma), q.dt_min, q.dt_max);
}

__global__ void march_fwd(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                          const unsigned char* __restrict__ grid,
                          const unsigned char* __restrict__ coarse, MarchParams q,
                          float* __restrict__ xyzs, float* __restrict__ deltas,
                          float* __restrict__ ts, unsigned char* __restrict__ mask,
                          float* __restrict__ nears, float* __restrict__ fars,
                          int* __restrict__ n_occupied, int* __restrict__ n_occupied_raw,
                          int* __restrict__ n_groups_occ) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= q.N) return;
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[n * 3 + a];
    d[a] = rays_d[n * 3 + a];
  }

  // prologue: slab test (ops/intersect.py:near_far_from_aabb)
  float near = -INFINITY, far = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = __fdiv_rn(1.0f, d[a]);
    const float t0 = __fmul_rn(__fsub_rn(q.aabb[a], o[a]), inv);
    const float t1 = __fmul_rn(__fsub_rn(q.aabb[3 + a], o[a]), inv);
    near = fmaxf(near, fminf(t0, t1));
    far = fminf(far, fmaxf(t0, t1));
  }
  const bool miss = near > far;
  near = fmaxf(near, q.min_near);
  if (miss) near = far = NGP_MISS;
  nears[n] = near;
  fars[n] = far;

  const long long row = (long long)n * q.budget;
  int kept = 0, occ_raw = 0, groups_occ = 0;
  float p[3];

  auto keep = [&](float t, float dt, const float* pos) {
    if (kept < q.budget) {
      const long long k = row + kept;
      ts[k] = t;
      deltas[k] = dt;
      xyzs[k * 3 + 0] = pos[0];
      xyzs[k * 3 + 1] = pos[1];
      xyzs[k * 3 + 2] = pos[2];
      mask[k] = 1;
    }
    ++kept;
  };

  const float t_start = near;
  if (q.prefilter) {
    const int n_groups = q.n_cand / q.group;
    const int mid = q.group / 2;
    float t_run = t_start;  // recurrence state at the start of the group (dt_gamma > 0)
    float tg[NGP_MAX_GROUP], dg[NGP_MAX_GROUP];
    for (int g = 0; g < n_groups; ++g) {
      for (int j = 0; j < q.group; ++j) {
        if (q.dt_gamma == 0.0f) {
          tg[j] = __fadd_rn(t_start, __fmul_rn((float)(g * q.group + j), q.dt_min));
          dg[j] = q.dt_min;
        } else {
          dg[j] = next_dt(t_run, q);
          tg[j] = t_run;
          t_run = __fadd_rn(t_run, dg[j]);
        }
      }
      if (!(tg[0] < far)) break;  // this and every later group start at/after far
      position(o, d, tg[mid], q.bound, p);
      if (!coarse_occupied(coarse, q, p, dg[mid])) continue;
      ++groups_occ;
      if (groups_occ > q.group_budget) continue;  // counted, never tested
      for (int j = 0; j < q.group; ++j) {
        if (!(tg[j] < far)) break;
        position(o, d, tg[j], q.bound, p);
        if (fine_occupied(grid, q, p, dg[j])) {
          ++occ_raw;
          keep(tg[j], dg[j], p);
        }
      }
    }
  } else {
    float t_run = t_start;
    int last_group = -1;
    for (int i = 0; i < q.n_cand; ++i) {
      float t, dt;
      if (q.dt_gamma == 0.0f) {
        t = __fadd_rn(t_start, __fmul_rn((float)i, q.dt_min));
        dt = q.dt_min;
      } else {
        t = t_run;
        dt = next_dt(t_run, q);
        t_run = __fadd_rn(t_run, dt);
      }
      if (!(t < far)) break;
      position(o, d, t, q.bound, p);
      if (fine_occupied(grid, q, p, dt)) {
        ++occ_raw;
        const int gi = i / q.group;
        if (gi != last_group) {
          ++groups_occ;
          last_group = gi;
        }
        keep(t, dt, p);
      }
    }
  }

  for (int s = kept; s < q.budget; ++s) {
    const long long k = row + s;
    ts[k] = 0.0f;
    deltas[k] = 0.0f;
    xyzs[k * 3 + 0] = 0.0f;
    xyzs[k * 3 + 1] = 0.0f;
    xyzs[k * 3 + 2] = 0.0f;
    mask[k] = 0;
  }
  n_occupied[n] = occ_raw;
  n_occupied_raw[n] = occ_raw;
  n_groups_occ[n] = groups_occ;
}

extern "C" int ngp_march(const void* rays_o, const void* rays_d, const float* aabb,
                         const void* grid, const void* coarse, int N, int C, int H, int Hc,
                         int n_cand, int budget, int group, int group_budget, int prefilter,
                         float bound, float min_near, float dt_min, float dt_max, float dt_gamma,
                         float mip0, void* xyzs, void* deltas, void* ts, void* mask, void* nears,
                         void* fars, void* n_occupied, void* n_occupied_raw, void* n_groups_occ,
                         void* stream) {
  if (group < 1 || group > NGP_MAX_GROUP) return (int)cudaErrorInvalidValue;
  if (prefilter && coarse == nullptr) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  MarchParams q;
  for (int i = 0; i < 6; ++i) q.aabb[i] = aabb[i];
  q.N = N;
  q.C = C;
  q.H = H;
  q.Hc = Hc;
  q.n_cand = n_cand;
  q.budget = budget;
  q.group = group;
  q.group_budget = group_budget;
  q.prefilter = prefilter;
  q.bound = bound;
  q.min_near = min_near;
  q.dt_min = dt_min;
  q.dt_max = dt_max;
  q.dt_gamma = dt_gamma;
  q.mip0 = mip0;
  const int threads = 64;  // 4096-ray chunks: spread the rays over 64 SMs
  march_fwd<<<ngp_blocks(N, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const unsigned char*)grid,
      (const unsigned char*)coarse, q, (float*)xyzs, (float*)deltas, (float*)ts,
      (unsigned char*)mask, (float*)nears, (float*)fars, (int*)n_occupied,
      (int*)n_occupied_raw, (int*)n_groups_occ);
  NGP_RETURN_LAST_ERROR();
}
