// K2: occupancy-grid ray marcher with the AABB slab test as its prologue.
//
// Replaces nerf_signature_tpu/ops/marching.py:_march_rays_impl (with
// _candidate_ts, _cells_and_levels and _select_first) and
// ops/intersect.py:near_far_from_aabb.  Per ray: near/far from the slab
// test; the candidate walk t_i = t0 + i*dt_min (dt_gamma == 0) or
// t_{i+1} = t_i + clip(t_i*dt_gamma, dt_min, dt_max); the cascade level and
// cell of each candidate; the first S occupied candidates kept in order;
// and the three counts n_occupied, n_occupied_raw and n_groups_occ with
// the JAX semantics.  With a perturbation `noise` [N] in [0, 1) (training),
// the walk starts at t0 = near + clip(near * dt_gamma, dt_min, dt_max) *
// noise, rounded like marching.py:340 (two products, one sum); NULL = no
// perturbation.  With the prefilter, the walk goes over groups of
// `group` candidates: the dilated coarse grid is tested at each group's
// midpoint (levels lmid-1..lmid+1 when C > 1), every occupied group is
// counted, and fine candidates are tested only inside the first
// `group_budget` occupied groups.
//
// What bounds it on the H100: bytes.  Per ray it reads 24 B of ray and
// writes S*(12+4+4+1) B of samples (22 MB for a 4096-ray chunk at S = 256);
// the grid lookups are single bytes from a 2 MB (fine) and a 256 KB
// (coarse) table that stay in L2.  What it must beat is latency: the walk
// is a chain of dependent L2 loads (up to 1024 candidates a ray).
//
// Design: one warp a ray, so a 4096-ray chunk is 4096 warps (~31 an SM).
// The walk goes in chunks of 32 candidates (or 32 groups), one a lane:
// - dt_gamma == 0: each lane computes its candidate in closed form; with
//   dt_gamma > 0 every lane runs the chunk's serial recurrence (the same
//   rounded steps as one thread would) and keeps its own step;
// - the occupied lanes are ranked by __ballot_sync + __popc, so a ray's
//   kept samples go to consecutive slots of its row from consecutive lanes
//   (coalesced stores), in candidate order;
// - t never decreases along the walk and no candidate at or past `far` can
//   be valid, so the walk ends after the first chunk with a lane at or past
//   far (or past n_cand): exact for the samples and for all three counts.
//   It does not stop at S, because the counts need the rest of the walk;
// - prefilter: a chunk tests 32 group midpoints against the dilated coarse
//   grid; a ballot prefix gives each occupied group its ordinal, compared
//   with group_budget (every occupied group is counted); then the admitted
//   groups' fine candidates are tested 32 / group groups a pass, lane =
//   (group, candidate), so lane order is candidate order;
// - the unused slots are zero-filled (as marching.py:521-524 writes them)
//   by a warp-wide coalesced loop.
// Position and cell arithmetic use __fmul_rn/__fadd_rn/__fdiv_rn (and the
// file is compiled with -fmad=false), so every candidate lands in the same
// cell as in the plain version: a flipped cell at a boundary would change
// which samples a ray keeps.
//
// The float render grid (ops/grid.py:render_grid; the transmittance cull,
// marching.py:494-502): the same walk reads a float32 cell value at the
// same flat index (4 B a tested candidate from an 8 MB table, in L2) and a
// candidate is occupied iff v > 0 (a cell occupied with a live density of 0
// is empty, as in JAX).  With t_cull > 0 each candidate's
// tau = occ ? v * dt : 0 enters a running fp32 sum along the ray: a warp
// inclusive scan (shuffles) over the chunk plus the carry from the chunks
// before it (lane 31's sum), over the admitted groups' candidates on the
// prefilter path as JAX does.  A candidate survives iff
// expf(tau - cum) >= t_cull; every candidate is tested (tau - cum need not
// be monotone at the last ulp).  n_occupied counts the survivors (their
// ranks give the slots), n_occupied_raw and n_groups_occ the pre-cull
// occupancy.  The scan adds in another order than torch.cumsum, so cum may
// differ from the plain version's in the last ulp: only a candidate whose
// t_in lies that close to t_cull can be kept by one and culled by the other.

#include "common.cuh"

#define NGP_MISS 3.4028235e38f
#define NGP_MAX_GROUP 16

struct MarchParams {
  float aabb[6];
  int N, C, H, Hc, n_cand, budget, group, group_budget, prefilter;
  float bound, min_near, dt_min, dt_max, dt_gamma, mip0, t_cull;
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

// Flat fine-grid index at position p (already clipped) with step dt.
__device__ __forceinline__ long long fine_index(const MarchParams& q, const float* p, float dt) {
  if (q.C == 1) return flat_cell(p, q.mip0, q.H);
  int lv = mip_level(p, dt, q.H, q.C);
  return (long long)lv * q.H * q.H * q.H + flat_cell(p, mip_bound(lv, q.bound), q.H);
}

// The fine grid's value at a flat index: 1 / 0 for the bool grid, the cell
// density (0 where unoccupied) for the float render grid; occupied iff > 0.
__device__ __forceinline__ float grid_value(const unsigned char* __restrict__ grid,
                                            long long idx) {
  return grid[idx] != 0 ? 1.0f : 0.0f;
}
__device__ __forceinline__ float grid_value(const float* __restrict__ grid, long long idx) {
  return grid[idx];
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

#define NGP_FULL 0xffffffffu
#define NGP_MARCH_WARPS 4

// The ray's output row and the warp's running counts; every lane holds the
// same counts and the same running sum of tau.
struct RayRow {
  float* xyzs;
  float* deltas;
  float* ts;
  unsigned char* mask;
  int budget, kept, occ_raw;
  float t_cull;     // > 0: the cull is on (float grid only)
  float cum = 0.0f;  // sum of tau over the ray's candidates so far (the cull)

  // Whether each lane's candidate survives the cull: tau = occ ? v * dt : 0,
  // cum = the running sum through this lane (warp inclusive scan + carry),
  // occ && exp(tau - cum) >= t_cull.  Warp-uniform call.
  __device__ __forceinline__ bool survives(bool occ, float v, float dt, int lane) {
    const float tau = occ ? __fmul_rn(v, dt) : 0.0f;
    float c = tau;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(NGP_FULL, c, off);
      if (lane >= off) c = __fadd_rn(y, c);
    }
    c = __fadd_rn(cum, c);
    cum = __shfl_sync(NGP_FULL, c, 31);
    return occ && expf(__fsub_rn(tau, c)) >= t_cull;
  }

  // Keep the sample of each lane with `occ` (and, with the cull on, `v`
  // surviving it), in lane order, after the samples kept so far; returns
  // the ballot of `occ` (the pre-cull occupancy).  Warp-uniform call.
  __device__ __forceinline__ unsigned keep(bool occ, float v, float t, float dt, const float* p,
                                           unsigned lanes_below, int lane) {
    const unsigned b = __ballot_sync(NGP_FULL, occ);
    const bool surv = t_cull > 0.0f ? survives(occ, v, dt, lane) : occ;
    const unsigned bs = t_cull > 0.0f ? __ballot_sync(NGP_FULL, surv) : b;
    if (surv) {
      const int s = kept + __popc(bs & lanes_below);
      if (s < budget) {
        ts[s] = t;
        deltas[s] = dt;
        xyzs[s * 3 + 0] = p[0];
        xyzs[s * 3 + 1] = p[1];
        xyzs[s * 3 + 2] = p[2];
        mask[s] = 1;
      }
    }
    kept += __popc(bs);
    occ_raw += __popc(b);
    return b;
  }
};

// Position of the n-th (from 0) set bit of mask, or -1.
__device__ __forceinline__ int nth_set_bit(unsigned mask, int n) {
  for (int i = 0; i < n && mask; ++i) mask &= mask - 1u;
  return mask ? __ffs(mask) - 1 : -1;
}

// GridT: unsigned char (the bool grid) or float (the float render grid).
template <typename GridT>
__global__ void __launch_bounds__(32 * NGP_MARCH_WARPS)
    march_fwd(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
              const GridT* __restrict__ grid, const unsigned char* __restrict__ coarse,
              const float* __restrict__ noise, MarchParams q, float* __restrict__ xyzs,
              float* __restrict__ deltas, float* __restrict__ ts,
              unsigned char* __restrict__ mask, float* __restrict__ nears,
              float* __restrict__ fars, int* __restrict__ n_occupied,
              int* __restrict__ n_occupied_raw, int* __restrict__ n_groups_occ) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * NGP_MARCH_WARPS + (threadIdx.x >> 5);  // one warp a ray
  if (n >= q.N) return;
  const unsigned below = (1u << lane) - 1u;
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[n * 3 + a];
    d[a] = rays_d[n * 3 + a];
  }

  // prologue: slab test (ops/intersect.py:near_far_from_aabb), every lane
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
  if (lane == 0) {
    nears[n] = near;
    fars[n] = far;
  }

  const long long row = (long long)n * q.budget;
  RayRow out{xyzs + row * 3, deltas + row, ts + row, mask + row, q.budget, 0, 0, q.t_cull};
  int groups_occ = 0;
  float p[3] = {0.0f, 0.0f, 0.0f};
  const bool closed = q.dt_gamma == 0.0f;  // closed-form candidates

  float t_start = near;
  if (noise != nullptr)
    t_start = __fadd_rn(near, __fmul_rn(next_dt(near, q), noise[n]));
  float t_run = t_start;  // dt_gamma > 0: the recurrence at the chunk's start
  if (q.prefilter) {
    const int G = q.group, n_groups = q.n_cand / G, mid = G / 2;
    const int per_pass = 32 / G;  // admitted groups a fine pass
    const int slot = lane / G, j = lane - slot * G;
    for (int gbase = 0; gbase < n_groups; gbase += 32) {
      const int gi = gbase + lane;
      float tf, tm, dm;  // the group's first candidate, its midpoint and its step
      if (closed) {
        tf = __fadd_rn(t_start, __fmul_rn((float)(gi * G), q.dt_min));
        tm = __fadd_rn(t_start, __fmul_rn((float)(gi * G + mid), q.dt_min));
        dm = q.dt_min;
      } else {
        tf = tm = dm = 0.0f;
        for (int k = 0; k < 32; ++k) {
          for (int c = 0; c < G; ++c) {
            const float dc = next_dt(t_run, q);
            if (k == lane && c == 0) tf = t_run;
            if (k == lane && c == mid) {
              tm = t_run;
              dm = dc;
            }
            t_run = __fadd_rn(t_run, dc);
          }
        }
      }
      const bool gvalid = gi < n_groups && tf < far;
      bool cocc = false;
      if (gvalid) {
        position(o, d, tm, q.bound, p);
        cocc = coarse_occupied(coarse, q, p, dm);
      }
      const unsigned cb = __ballot_sync(NGP_FULL, cocc);
      // the group's ordinal among the ray's occupied groups, from 0
      const bool admit = cocc && groups_occ + __popc(cb & below) < q.group_budget;
      unsigned rest = __ballot_sync(NGP_FULL, admit);
      groups_occ += __popc(cb);
      // the admitted groups' fine candidates, per_pass groups at a time
      while (rest) {
        const int src = slot < per_pass ? nth_set_bit(rest, slot) : -1;
        const float tf_src = __shfl_sync(NGP_FULL, tf, src < 0 ? 0 : src);
        float t, dt;
        if (closed) {
          t = __fadd_rn(t_start, __fmul_rn((float)((gbase + src) * G + j), q.dt_min));
          dt = q.dt_min;
        } else {
          t = tf_src;
          for (int c = 0; c < j; ++c) t = __fadd_rn(t, next_dt(t, q));
          dt = next_dt(t, q);
        }
        float v = 0.0f;
        if (src >= 0 && t < far) {
          position(o, d, t, q.bound, p);
          v = grid_value(grid, fine_index(q, p, dt));
        }
        out.keep(v > 0.0f, v, t, dt, p, below, lane);
        for (int k = 0; k < per_pass && rest; ++k) rest &= rest - 1u;
      }
      if (!__all_sync(NGP_FULL, gvalid)) break;
    }
  } else {
    int last_occ = -1;  // the last occupied candidate so far
    for (int base = 0; base < q.n_cand; base += 32) {
      const int i = base + lane;
      float t, dt;
      if (closed) {
        t = __fadd_rn(t_start, __fmul_rn((float)i, q.dt_min));
        dt = q.dt_min;
      } else {
        t = dt = 0.0f;
        for (int k = 0; k < 32; ++k) {
          const float dk = next_dt(t_run, q);
          if (k == lane) {
            t = t_run;
            dt = dk;
          }
          t_run = __fadd_rn(t_run, dk);
        }
      }
      const bool valid = i < q.n_cand && t < far;
      float v = 0.0f;
      if (valid) {
        position(o, d, t, q.bound, p);
        v = grid_value(grid, fine_index(q, p, dt));
      }
      const bool occ = v > 0.0f;
      const unsigned b = out.keep(occ, v, t, dt, p, below, lane);
      // an occupied candidate opens a group unless the occupied one before
      // it lies in the same group
      const int prev = (b & below) ? base + 31 - __clz(b & below) : last_occ;
      const bool opens = occ && (prev < 0 || prev / q.group != i / q.group);
      groups_occ += __popc(__ballot_sync(NGP_FULL, opens));
      if (b) last_occ = base + 31 - __clz(b);
      if (!__all_sync(NGP_FULL, valid)) break;
    }
  }

  // zeros past the last kept sample, lanes on consecutive addresses
  const int k0 = min(out.kept, q.budget);
  for (int s = k0 + lane; s < q.budget; s += 32) {
    out.ts[s] = 0.0f;
    out.deltas[s] = 0.0f;
    out.mask[s] = 0;
  }
  for (int f = 3 * k0 + lane; f < 3 * q.budget; f += 32) out.xyzs[f] = 0.0f;
  if (lane == 0) {
    n_occupied[n] = out.kept;
    n_occupied_raw[n] = out.occ_raw;
    n_groups_occ[n] = groups_occ;
  }
}

// grid_float: 0 = the bool grid (1 byte a cell), 1 = the float render grid
// (4 B a cell); t_cull > 0 needs the float grid.
extern "C" int ngp_march(const void* rays_o, const void* rays_d, const float* aabb,
                         const void* grid, const void* coarse, const void* noise, int N, int C,
                         int H, int Hc,
                         int n_cand, int budget, int group, int group_budget, int prefilter,
                         int grid_float, float bound, float min_near, float dt_min, float dt_max,
                         float dt_gamma, float mip0, float t_cull, void* xyzs, void* deltas,
                         void* ts, void* mask, void* nears, void* fars, void* n_occupied,
                         void* n_occupied_raw, void* n_groups_occ, void* stream) {
  if (group < 1 || group > NGP_MAX_GROUP) return (int)cudaErrorInvalidValue;
  if (prefilter && coarse == nullptr) return (int)cudaErrorInvalidValue;
  if (t_cull > 0.0f && !grid_float) return (int)cudaErrorInvalidValue;
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
  q.t_cull = grid_float ? t_cull : 0.0f;
  const unsigned blocks = ngp_blocks(N, NGP_MARCH_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (grid_float)
    march_fwd<float><<<blocks, 32 * NGP_MARCH_WARPS, 0, s>>>(
        (const float*)rays_o, (const float*)rays_d, (const float*)grid,
        (const unsigned char*)coarse, (const float*)noise, q, (float*)xyzs, (float*)deltas,
        (float*)ts, (unsigned char*)mask, (float*)nears, (float*)fars, (int*)n_occupied,
        (int*)n_occupied_raw, (int*)n_groups_occ);
  else
    march_fwd<unsigned char><<<blocks, 32 * NGP_MARCH_WARPS, 0, s>>>(
        (const float*)rays_o, (const float*)rays_d, (const unsigned char*)grid,
        (const unsigned char*)coarse, (const float*)noise, q, (float*)xyzs, (float*)deltas,
        (float*)ts, (unsigned char*)mask, (float*)nears, (float*)fars, (int*)n_occupied,
        (int*)n_occupied_raw, (int*)n_groups_occ);
  NGP_RETURN_LAST_ERROR();
}
