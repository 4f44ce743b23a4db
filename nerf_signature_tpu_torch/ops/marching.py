"""Static-budget occupancy-grid ray marching (K2).

Counterpart of ``nerf_signature_tpu/ops/marching.py``.  A ray's candidate
t-values form a fixed sequence (``t0 + i*dt_min`` when dt_gamma == 0, the
clamp recurrence otherwise); marching keeps the first S candidates that fall
in occupied cells, in order, and pads the rest.  The optional coarse
prefilter tests a dilated coarse grid once per group of ``group`` candidates
and tests fine cells only inside the first ``group_budget`` occupied groups.

``march_rays`` is the plain version with the JAX signature (near/far given).
``march_rays_aabb`` is the kernel wrapper: the kernel (``csrc/marcher.cu``)
runs the AABB slab test as its prologue, so it takes the box and returns
``nears``/``fars`` beside the samples.  The JAX package's ``NGP_MARCH_*``
environment overrides are not carried over; the same values are arguments.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .intersect import near_far_from_aabb

SQRT3 = 1.7320508075688772


def dt_bounds(max_steps, cascade, grid_size):
    """(dt_min, dt_max) as Python floats."""
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cascade - 1)) / grid_size
    return dt_min, dt_max


def num_candidates(bound, max_steps, dt_gamma):
    """Candidate-grid length covering a full AABB traversal."""
    if dt_gamma > 0:
        return max_steps
    return int(math.ceil(bound)) * max_steps


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """The static shape of one march: what ``march_rays`` resolves from its
    arguments (the prefilter's auto rule included) before touching data."""

    n_cand: int
    budget: int
    prefilter: bool
    group: int
    coarse_factor: int
    group_budget: int
    dil: int          # coarse-grid dilation (prefilter only)
    dt_min: float     # float32-rounded
    dt_max: float


def march_plan(C, H, *, bound, dt_gamma=0.0, max_steps=1024, n_cand=None,
               budget=128, prefilter=None, group=4, coarse_factor=2,
               group_budget=None):
    """Resolve the march's static options like ``march_rays`` does in JAX."""
    if n_cand is None:
        n_cand = num_candidates(bound, max_steps, dt_gamma)
    if group_budget is None:
        group_budget = max(64, budget // 2)
    n_groups = max(n_cand // group, 1)
    group_budget = min(group_budget, n_groups)
    if prefilter is None:
        # on when it shrinks the fine-gather population and the coarse grid
        # can discriminate (Hc >= 16)
        prefilter = (n_cand % group == 0 and group_budget * group < n_cand
                     and H % coarse_factor == 0 and H // coarse_factor >= 16)
    prefilter = bool(prefilter and n_cand % group == 0 and n_cand >= group
                     and H % coarse_factor == 0 and H // coarse_factor >= 2)
    dt_min, dt_max = dt_bounds(max_steps, C, H)
    dil = 0
    if prefilter:
        # conservative dilation: a group spans at most group*dt of distance,
        # i.e. ceil(span * Hc / (2 * mip_bound)) coarse cells, with the
        # worst-case mip_bound min(1, bound)
        span = group * (dt_min if dt_gamma == 0 else dt_max)
        dil = max(1, int(math.ceil(span * (H // coarse_factor) / (2.0 * min(1.0, bound)))))
    return MarchPlan(n_cand=n_cand, budget=budget, prefilter=prefilter,
                     group=group, coarse_factor=coarse_factor,
                     group_budget=group_budget, dil=dil,
                     dt_min=float(np.float32(dt_min)),
                     dt_max=float(np.float32(dt_max)))


def coarse_occupancy(occupancy, factor):
    """OR-pool [C, H, H, H] bool to [C, H/f, H/f, H/f]."""
    C, H = occupancy.shape[0], occupancy.shape[1]
    Hc = H // factor
    return occupancy.reshape(C, Hc, factor, Hc, factor, Hc, factor).any(
        dim=6).any(dim=4).any(dim=2)


def dilate_occupancy(coarse, dil):
    """OR-dilate [C, Hc, Hc, Hc] bool by ``dil`` cells per axis: a max pool on
    a float copy, whose implicit padding plays JAX's False padding."""
    if dil <= 0:
        return coarse
    x = coarse.to(torch.float32).unsqueeze(1)
    y = F.max_pool3d(x, kernel_size=2 * dil + 1, stride=1, padding=dil)
    return y.squeeze(1) > 0.5


def coarse_grid(occupancy, plan: MarchPlan):
    """The dilated coarse grid a prefiltered march tests (None without the
    prefilter).  Build it once per grid, not once per chunk."""
    if not plan.prefilter:
        return None
    return dilate_occupancy(coarse_occupancy(occupancy, plan.coarse_factor), plan.dil)


def _candidate_ts(t0, n_cand, dt_min, dt_max, dt_gamma):
    """Per-ray candidate t-grid and step sizes: ts, dts [N, T]."""
    if dt_gamma == 0:
        steps = torch.arange(n_cand, dtype=t0.dtype, device=t0.device)
        ts = t0[:, None] + steps[None, :] * dt_min
        return ts, torch.full_like(ts, dt_min)
    ts, dts = [], []
    t = t0
    for _ in range(n_cand):
        dt = torch.clamp(t * dt_gamma, dt_min, dt_max)
        ts.append(t)
        dts.append(dt)
        t = t + dt
    return torch.stack(ts, dim=-1), torch.stack(dts, dim=-1)


def _mip_levels(pos, dts, C, H):
    mx = torch.maximum(pos[0].abs(), torch.maximum(pos[1].abs(), pos[2].abs()))
    e_pos = torch.floor(torch.log2(torch.clamp_min(mx, 1e-30))) + 1.0
    e_dt = torch.floor(torch.log2(torch.clamp_min(dts * H * 0.5, 1e-30))) + 1.0
    return torch.clamp(torch.maximum(e_pos, e_dt), 0, C - 1).to(torch.int64)


def _cells(pos, mb, H):
    """Row-major flat cell index of per-axis positions in mip box ``mb``.
    ``mb`` is a tensor so the division is a true division on every device."""
    cell = [torch.clamp(0.5 * (p / mb + 1.0) * H, 0.0, H - 1).to(torch.int64)
            for p in pos]
    return (cell[0] * H + cell[1]) * H + cell[2]


def _cells_and_levels(pos, dts, C, H, bound):
    """Flat grid indices with the reference's mip-level selection when
    C > 1.  Returns (flat_idx, level)."""
    dev = pos[0].device
    if C == 1:
        mb = torch.tensor(min(1.0, bound), dtype=torch.float32, device=dev)
        return _cells(pos, mb, H), None
    level = _mip_levels(pos, dts, C, H)
    mb = torch.minimum(torch.exp2(level.to(torch.float32)),
                       torch.tensor(bound, dtype=torch.float32, device=dev))
    return level * (H * H * H) + _cells(pos, mb, H), level


def _select_first(occ, idx_vals, budget):
    """Keep the first ``budget`` True positions per row, in order: cumsum
    rank + one scatter.  Returns (sel [N, budget] int64, n_true [N] int32)."""
    N = occ.shape[0]
    rank = torch.cumsum(occ.to(torch.int64), dim=-1) - 1
    dst = torch.where(occ & (rank < budget), rank, budget)
    vals = torch.broadcast_to(idx_vals, occ.shape).to(torch.int64)
    sel = torch.zeros((N, budget + 1), dtype=torch.int64, device=occ.device)
    sel.scatter_(1, dst, vals)
    return sel[:, :budget], occ.sum(dim=-1, dtype=torch.int32)


def _positions(rays_o, rays_d, ts, bound):
    return [torch.clamp(rays_o[:, a:a + 1] + ts * rays_d[:, a:a + 1], -bound, bound)
            for a in range(3)]


def march_rays(rays_o, rays_d, occupancy, nears, fars, *, bound, dt_gamma=0.0,
               max_steps=1024, n_cand=None, budget=128, grid_size=128,
               noise=None, prefilter=None, group=4, coarse_factor=2,
               group_budget=None, t_cull=0.0, coarse=None):
    """March N rays through the occupancy grid with a fixed sample budget
    (plain PyTorch, any device).

    occupancy: [C, H, H, H] bool, or the float render grid (enables
    ``t_cull``).  noise: optional [N] U[0, 1) perturbation of t0 (the JAX
    version draws it from ``perturb_key``).  coarse: the dilated coarse grid
    from ``coarse_grid`` (built here when None).
    Returns dict(xyzs [N,S,3], dirs [N,S,3], deltas, ts [N,S], mask [N,S]
    bool, n_occupied, n_occupied_raw, n_groups_occ [N] int32).
    """
    if t_cull > 0 and occupancy.dtype == torch.bool:
        raise ValueError("t_cull > 0 needs the float density render grid "
                         "(ops.grid.render_grid), not the bool occupancy field")
    C, H = occupancy.shape[0], occupancy.shape[1]
    if H != grid_size:
        raise ValueError(f"grid side {H} != grid_size {grid_size}")
    plan = march_plan(C, H, bound=bound, dt_gamma=dt_gamma, max_steps=max_steps,
                      n_cand=n_cand, budget=budget, prefilter=prefilter,
                      group=group, coarse_factor=coarse_factor,
                      group_budget=group_budget)
    if coarse is None:
        coarse = coarse_grid(occupancy, plan)
    return _march_plain(rays_o, rays_d, occupancy, coarse, nears, fars, plan,
                        bound, dt_gamma, noise, t_cull)


def _march_plain(rays_o, rays_d, occupancy, coarse, nears, fars, plan, bound,
                 dt_gamma, noise, t_cull):
    C, H = occupancy.shape[0], occupancy.shape[1]
    N = rays_o.shape[0]
    dev = rays_o.device
    f32 = torch.float32
    n_cand, group, budget = plan.n_cand, plan.group, plan.budget
    dt_min, dt_max = plan.dt_min, plan.dt_max

    t0 = nears
    if noise is not None:
        t0 = t0 + torch.clamp(t0 * dt_gamma, dt_min, dt_max) * noise

    flat_occ = occupancy.reshape(-1)
    n_groups_occ = None
    cand_extra_valid = None
    if not plan.prefilter:
        ts, dts = _candidate_ts(t0, n_cand, dt_min, dt_max, dt_gamma)
        cand = torch.arange(n_cand, device=dev).expand(N, n_cand)
    else:
        Hc = H // plan.coarse_factor
        n_groups = n_cand // group
        gb = plan.group_budget
        mid_off = group // 2
        if dt_gamma == 0:
            gi = torch.arange(n_groups, dtype=f32, device=dev)
            ts_mid = t0[:, None] + (gi * group + mid_off)[None, :] * dt_min
            dts_mid = torch.full_like(ts_mid, dt_min)
            ts_first = t0[:, None] + (gi * group)[None, :] * dt_min
        else:
            ts_all, dts_all = _candidate_ts(t0, n_cand, dt_min, dt_max, dt_gamma)
            ts_mid = ts_all[:, mid_off::group]
            dts_mid = dts_all[:, mid_off::group]
            ts_first = ts_all[:, ::group]
        pos_mid = _positions(rays_o, rays_d, ts_mid, bound)
        flat_coarse = coarse.reshape(-1)
        if C == 1:
            mb = torch.tensor(min(1.0, bound), dtype=f32, device=dev)
            group_occ = flat_coarse[_cells(pos_mid, mb, Hc)]
        else:
            # the per-candidate level can drift +-1 from the midpoint's
            # within a group: test all three levels
            lmid = _mip_levels(pos_mid, dts_mid, C, H)
            bound_t = torch.tensor(bound, dtype=f32, device=dev)
            group_occ = torch.zeros(ts_mid.shape, dtype=torch.bool, device=dev)
            for dl in (-1, 0, 1):
                lv = torch.clamp(lmid + dl, 0, C - 1)
                mb = torch.minimum(torch.exp2(lv.to(f32)), bound_t)
                gidx = lv * (Hc * Hc * Hc) + _cells(pos_mid, mb, Hc)
                group_occ = group_occ | flat_coarse[gidx]
        group_occ = group_occ & (ts_first < fars[:, None])
        sel_g, n_g = _select_first(
            group_occ, torch.arange(n_groups, device=dev)[None, :], gb)
        # counted over ALL groups, before the group-budget truncation
        n_groups_occ = n_g
        gmask = (torch.arange(gb, device=dev)[None, :]
                 < torch.clamp_max(n_g, gb)[:, None])
        cand = (sel_g[:, :, None] * group
                + torch.arange(group, device=dev)[None, None, :]).reshape(N, gb * group)
        cand_extra_valid = gmask.repeat_interleave(group, dim=-1)
        if dt_gamma == 0:
            ts = t0[:, None] + cand.to(f32) * dt_min
            dts = torch.full_like(ts, dt_min)
        else:
            ts = torch.take_along_dim(ts_all, cand, dim=-1)
            dts = torch.take_along_dim(dts_all, cand, dim=-1)

    valid = ts < fars[:, None]
    if cand_extra_valid is not None:
        valid = valid & cand_extra_valid
    flat_idx, _ = _cells_and_levels(_positions(rays_o, rays_d, ts, bound), dts, C, H, bound)
    vals = flat_occ[flat_idx]
    occ = (vals if vals.dtype == torch.bool else vals > 0) & valid
    n_occ_raw = occ.sum(dim=-1, dtype=torch.int32)

    if n_groups_occ is None:
        # unfiltered path: occupied fine groups (any occupied candidate in
        # each group of `group`)
        pad = (-occ.shape[1]) % group
        og = F.pad(occ, (0, pad)) if pad else occ
        n_groups_occ = og.reshape(N, -1, group).any(dim=-1).sum(dim=-1, dtype=torch.int32)

    if t_cull > 0 and vals.dtype != torch.bool:
        tau = torch.where(occ, vals * dts, 0.0)
        t_in = torch.exp(tau - torch.cumsum(tau, dim=-1))
        occ = occ & (t_in >= t_cull)

    pos_in_row = torch.arange(occ.shape[1], device=dev)[None, :]
    sel, n_occupied = _select_first(occ, pos_in_row, budget)
    mask = (torch.arange(budget, device=dev)[None, :]
            < torch.clamp_max(n_occupied, budget)[:, None])
    ts_sel = torch.take_along_dim(ts, sel, dim=-1)
    dts_sel = torch.take_along_dim(dts, sel, dim=-1)
    xyzs = torch.clamp(rays_o[:, None, :] + ts_sel[..., None] * rays_d[:, None, :],
                       -bound, bound)
    return {
        "xyzs": torch.where(mask[..., None], xyzs, 0.0),
        "dirs": rays_d[:, None, :].expand(N, budget, 3),
        "deltas": torch.where(mask, dts_sel, 0.0),
        "ts": torch.where(mask, ts_sel, 0.0),
        "mask": mask,
        "n_occupied": n_occupied,
        "n_occupied_raw": n_occ_raw,
        "n_groups_occ": n_groups_occ,
    }


def march_rays_aabb(rays_o, rays_d, aabb, occupancy, *, min_near, bound,
                    dt_gamma=0.0, max_steps=1024, n_cand=None, budget=128,
                    prefilter=None, group=4, coarse_factor=2,
                    group_budget=None, coarse=None, noise=None, plain=False):
    """K2 wrapper: slab test against ``aabb`` ([6] floats) + march.

    CPU tensors (or ``plain=True``) run ``near_far_from_aabb`` and
    ``march_rays``; CUDA tensors launch the marcher kernel, which takes the
    bool grid.  ``noise``: optional [N] U[0, 1) perturbation of t0 (training;
    the JAX version draws it from ``perturb_key``), bit-exact between the
    two.  Returns the ``march_rays`` dict plus ``nears`` and ``fars`` [N]."""
    C, H = occupancy.shape[0], occupancy.shape[1]
    plan = march_plan(C, H, bound=bound, dt_gamma=dt_gamma, max_steps=max_steps,
                      n_cand=n_cand, budget=budget, prefilter=prefilter,
                      group=group, coarse_factor=coarse_factor,
                      group_budget=group_budget)
    if coarse is None:
        coarse = coarse_grid(occupancy, plan)
    if plain or not rays_o.is_cuda:
        nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
        out = _march_plain(rays_o, rays_d, occupancy, coarse, nears, fars, plan,
                           bound, dt_gamma, noise, 0.0)
        out.update(nears=nears, fars=fars)
        return out
    if occupancy.dtype != torch.bool:
        raise NotImplementedError(
            "the marcher kernel takes the bool occupancy grid; the float "
            "render grid (t_cull > 0) is ROADMAP queue 2 item K2 (t_cull)")
    N = rays_o.shape[0]
    S = plan.budget
    dev = rays_o.device
    _cuda.check(rays_o, "rays_o", torch.float32, (N, 3))
    _cuda.check(rays_d, "rays_d", torch.float32, (N, 3), dev)
    _cuda.check(occupancy, "occupancy", torch.bool, (C, H, H, H), dev)
    if coarse is not None:
        Hc = H // plan.coarse_factor
        _cuda.check(coarse, "coarse", torch.bool, (C, Hc, Hc, Hc), dev)
    if noise is not None:
        _cuda.check(noise, "noise", torch.float32, (N,), dev)
    aabb_host = np.ascontiguousarray(
        torch.as_tensor(aabb, dtype=torch.float32).reshape(6).cpu().numpy())
    f32 = torch.float32
    out = {
        "xyzs": torch.empty((N, S, 3), dtype=f32, device=dev),
        "deltas": torch.empty((N, S), dtype=f32, device=dev),
        "ts": torch.empty((N, S), dtype=f32, device=dev),
        "mask": torch.empty((N, S), dtype=torch.bool, device=dev),
        "nears": torch.empty((N,), dtype=f32, device=dev),
        "fars": torch.empty((N,), dtype=f32, device=dev),
        "n_occupied": torch.empty((N,), dtype=torch.int32, device=dev),
        "n_occupied_raw": torch.empty((N,), dtype=torch.int32, device=dev),
        "n_groups_occ": torch.empty((N,), dtype=torch.int32, device=dev),
    }
    _cuda.MARCH(
        rays_o.data_ptr(), rays_d.data_ptr(), aabb_host.ctypes.data_as(_cuda._FP),
        occupancy.data_ptr(), _cuda.ptr(coarse), _cuda.ptr(noise),
        N, C, H, H // plan.coarse_factor, plan.n_cand, S, plan.group,
        plan.group_budget, int(plan.prefilter),
        float(bound), float(min_near), plan.dt_min, plan.dt_max, float(dt_gamma),
        float(min(1.0, bound)),
        out["xyzs"].data_ptr(), out["deltas"].data_ptr(), out["ts"].data_ptr(),
        out["mask"].data_ptr(), out["nears"].data_ptr(), out["fars"].data_ptr(),
        out["n_occupied"].data_ptr(), out["n_occupied_raw"].data_ptr(),
        out["n_groups_occ"].data_ptr())
    out["dirs"] = rays_d[:, None, :].expand(N, S, 3)
    return out
