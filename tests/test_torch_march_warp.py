"""K2's warp walk (``csrc/marcher.cu``: one warp a ray, candidates in
chunks of 32) emulated in plain PyTorch and held against ``_march_plain``,
the marcher's plain version, on the CPU.

The CUDA kernel cannot run here, so this file pins its algorithm: per chunk
of 32 candidates (or 32 group midpoints with the prefilter) each lane tests
one, ``__ballot_sync`` + ``__popc`` rank the occupied lanes after the
samples kept so far, the prefilter gives each occupied group its ordinal
by a ballot prefix and tests the fine candidates of the groups under
``group_budget`` ``32 // group`` groups a pass, and the walk ends after the
first chunk with a lane at or past ``far``.  The emulation uses the plain
version's own cell and level arithmetic, so everything must be equal:
masks, samples and all three counts (the kernel is held bit for bit against
the plain version on the card, ``tests/test_torch_kernels.py``).

On the float render grid with ``t_cull > 0`` the walk also keeps the
kernel's running sum of tau: a Hillis-Steele scan over each chunk's 32
lanes (``__shfl_up_sync``) plus the carry from lane 31 of the chunk
before.  That adds in another order than the plain version's cumsum, so
the two are held equal on every ray but those where some candidate's
entering transmittance lies within ``CULL_MARGIN`` of ``t_cull``
(``cull_margin``), and those are counted: none on these inputs.
"""

import numpy as np
import pytest
import torch

from nerf_signature_tpu_torch.ops import marching as t_march
from nerf_signature_tpu_torch.ops.intersect import near_far_from_aabb

LANES = 32


def _rays(rng, n, bound):
    o = rng.normal(size=(n, 3)) * 0.3 * bound + np.array([0.0, 0.0, -2.6 * bound])
    d = rng.normal(size=(n, 3)) * 0.25 + np.array([0.0, 0.0, 1.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = np.array([0.0, 1.0, 0.0])  # misses the box
    return (torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32))


def _exclusive_count(m):
    """__popc(ballot & lanes_below) for every lane: [N, K] -> [N, K]."""
    c = torch.cumsum(m.to(torch.int64), dim=-1)
    return c - m.to(torch.int64)


class _Walk:
    """The kernel's per-ray state, one entry a ray (a warp)."""

    def __init__(self, o, d, occ, coarse, near, far, t_start, plan, bound, gamma, t_cull):
        N = o.shape[0]
        self.t_cull = t_cull
        self.cum = torch.zeros(N)  # the running sum of tau (the cull)
        self.o, self.d, self.occ, self.coarse = o, d, occ, coarse
        self.far, self.t_start, self.plan, self.bound, self.gamma = far, t_start, plan, bound, gamma
        self.C, self.H = occ.shape[0], occ.shape[1]
        S = plan.budget
        self.kept = torch.zeros(N, dtype=torch.int64)
        self.occ_raw = torch.zeros(N, dtype=torch.int64)
        self.groups = torch.zeros(N, dtype=torch.int64)
        self.done = torch.zeros(N, dtype=torch.bool)
        self.ts = torch.zeros((N, S))
        self.deltas = torch.zeros((N, S))
        self.xyzs = torch.zeros((N, S, 3))
        self.mask = torch.zeros((N, S), dtype=torch.bool)

    def step(self, t):
        return torch.clamp(t * self.gamma, self.plan.dt_min, self.plan.dt_max)

    def positions(self, t):
        return t_march._positions(self.o, self.d, t, self.bound)

    def fine(self, t, dt):
        """The grid's value at each candidate as a float: 1 / 0 on the bool
        grid, the cell density on the float one (occupied iff > 0)."""
        idx, _ = t_march._cells_and_levels(self.positions(t), dt, self.C, self.H, self.bound)
        return self.occ.reshape(-1)[idx].to(torch.float32)

    def survives(self, occ, v, dt):
        """The cull over one chunk of 32 lanes: the warp's inclusive scan
        of tau in the kernel's order, plus the carry."""
        tau = torch.where(occ, v * dt, 0.0)
        lane = torch.arange(LANES)
        c, off = tau, 1
        while off < LANES:
            y = torch.cat([torch.zeros((c.shape[0], off)), c[:, :-off]], -1)
            c = torch.where(lane[None, :] >= off, y + c, c)
            off *= 2
        c = self.cum[:, None] + c
        self.cum = c[:, -1]
        return occ & (torch.exp(tau - c) >= self.t_cull)

    def coarse_at(self, t, dt):
        pos = self.positions(t)
        Hc, C = self.H // self.plan.coarse_factor, self.C
        flat = self.coarse.reshape(-1)
        if C == 1:
            mb = torch.tensor(min(1.0, self.bound))
            return flat[t_march._cells(pos, mb, Hc)]
        lmid = t_march._mip_levels(pos, dt, C, self.H)
        hit = torch.zeros(t.shape, dtype=torch.bool)
        for dl in (-1, 0, 1):
            lv = torch.clamp(lmid + dl, 0, C - 1)
            mb = torch.minimum(torch.exp2(lv.to(torch.float32)), torch.tensor(self.bound))
            hit = hit | flat[lv * Hc**3 + t_march._cells(pos, mb, Hc)]
        return hit

    def keep(self, valid, v, t, dt):
        """The lanes' ballot rank after the samples kept so far; stores the
        kept samples (lane order) below the budget.  Returns the pre-cull
        occupancy."""
        occ = valid & (v > 0)
        surv = self.survives(occ, v, dt) if self.t_cull > 0 else occ
        slot = self.kept[:, None] + _exclusive_count(surv)
        ok = surv & (slot < self.plan.budget)
        r, c = torch.nonzero(ok, as_tuple=True)
        s = slot[r, c]
        self.ts[r, s] = t[r, c]
        self.deltas[r, s] = dt[r, c]
        pos = self.positions(t)
        for a in range(3):
            self.xyzs[r, s, a] = pos[a][r, c]
        self.mask[r, s] = True
        self.kept += surv.sum(-1)
        self.occ_raw += occ.sum(-1)
        return occ

    def chunk_ts(self, t_run, count):
        """Every lane runs the chunk's serial recurrence (dt_gamma > 0):
        the ``count`` candidates from t_run, and the state after them."""
        ts, dts = [], []
        for _ in range(count):
            dt = self.step(t_run)
            ts.append(t_run)
            dts.append(dt)
            t_run = t_run + dt
        return torch.stack(ts, -1), torch.stack(dts, -1), t_run


def warp_walk(o, d, aabb, occ, *, min_near, bound, dt_gamma=0.0, max_steps=1024,
              n_cand=None, budget=128, prefilter=None, group=4, group_budget=None,
              noise=None, t_cull=0.0):
    """The kernel's walk: returns the ``march_rays_aabb`` dict (no dirs)."""
    C, H = occ.shape[0], occ.shape[1]
    plan = t_march.march_plan(C, H, bound=bound, dt_gamma=dt_gamma, max_steps=max_steps,
                              n_cand=n_cand, budget=budget, prefilter=prefilter, group=group,
                              group_budget=group_budget)
    coarse = t_march.coarse_grid(occ, plan)
    near, far = near_far_from_aabb(o, d, aabb, min_near)
    t_start = near
    if noise is not None:
        t_start = near + torch.clamp(near * dt_gamma, plan.dt_min, plan.dt_max) * noise
    w = _Walk(o, d, occ, coarse, near, far, t_start, plan, bound, dt_gamma, t_cull)
    closed = dt_gamma == 0
    lane = torch.arange(LANES)
    t_run = t_start.clone()
    G = plan.group
    if plan.prefilter:
        n_groups, mid, per_pass = plan.n_cand // G, G // 2, LANES // G
        for gbase in range(0, n_groups, LANES):
            gi = gbase + lane
            if closed:
                tf = t_start[:, None] + (gi * G).to(torch.float32) * plan.dt_min
                tm = t_start[:, None] + (gi * G + mid).to(torch.float32) * plan.dt_min
                dm = torch.full_like(tm, plan.dt_min)
            else:
                ts_, dts_, t_run = w.chunk_ts(t_run, LANES * G)
                tf, tm, dm = ts_[:, ::G], ts_[:, mid::G], dts_[:, mid::G]
            gvalid = (gi < n_groups)[None, :] & (tf < far[:, None]) & ~w.done[:, None]
            cocc = gvalid & w.coarse_at(tm, dm)
            # the ballot prefix: each occupied group's ordinal against the budget
            admit = cocc & (w.groups[:, None] + _exclusive_count(cocc) < plan.group_budget)
            w.groups += cocc.sum(-1)
            arank = _exclusive_count(admit)
            for first in range(0, int(admit.sum(-1).max()), per_pass):
                # lane (slot, j): candidate j of the slot-th admitted group
                slot, j = lane // G, lane % G
                want = first + slot
                hit = admit[:, None, :] & (arank[:, None, :] == want[None, :, None])
                src = torch.where(hit.any(-1) & (slot < per_pass)[None, :],
                                  hit.to(torch.int64).argmax(-1), -1)
                src_c = src.clamp_min(0)
                if closed:
                    idx = (gbase + src) * G + j[None, :]
                    t = t_start[:, None] + idx.to(torch.float32) * plan.dt_min
                    dt = torch.full_like(t, plan.dt_min)
                else:
                    t = torch.take_along_dim(tf, src_c, -1)
                    for c in range(G - 1):
                        t = torch.where(j[None, :] > c, t + w.step(t), t)
                    dt = w.step(t)
                fvalid = (src >= 0) & (t < far[:, None])
                w.keep(fvalid, w.fine(t, dt), t, dt)
            w.done |= ~gvalid.all(-1)
    else:
        last = torch.full((o.shape[0],), -1, dtype=torch.int64)
        for base in range(0, plan.n_cand, LANES):
            i = base + lane
            if closed:
                t = t_start[:, None] + i.to(torch.float32) * plan.dt_min
                dt = torch.full_like(t, plan.dt_min)
            else:
                t, dt, t_run = w.chunk_ts(t_run, LANES)
            valid = (i < plan.n_cand)[None, :] & (t < far[:, None]) & ~w.done[:, None]
            occ_c = w.keep(valid, w.fine(t, dt), t, dt)
            # an occupied candidate opens a group unless the occupied one
            # before it (in this chunk, or the last one before it) is in its group
            at = torch.where(occ_c, i[None, :], -1)
            before = torch.cat([last[:, None], at[:, :-1]], -1).cummax(-1).values
            opens = occ_c & ((before < 0) | (before // G != i[None, :] // G))
            w.groups += opens.sum(-1)
            last = torch.maximum(last, at.max(-1).values)
            w.done |= ~valid.all(-1)
    return {"xyzs": w.xyzs, "deltas": w.deltas, "ts": w.ts, "mask": w.mask,
            "nears": near, "fars": far, "n_occupied": w.kept.to(torch.int32),
            "n_occupied_raw": w.occ_raw.to(torch.int32),
            "n_groups_occ": w.groups.to(torch.int32)}


WALK_CASES = [
    # (bound, prefilter, dt_gamma, group, group_budget, noise)
    (b, pf, g, 4, None, noise)
    for b in (1.0, 2.0) for pf in (True, False) for g in (0.0, 1 / 128)
    for noise in (False, True)
] + [
    (1.0, True, 0.0, 4, 3, False),      # a group budget that truncates
    (2.0, True, 1 / 128, 4, 2, True),
    (1.0, True, 0.0, 3, 5, False),      # groups that do not divide 32
    (1.0, False, 0.0, 3, None, False),
    (2.0, True, 1 / 128, 16, 4, False),  # NGP_MAX_GROUP
]


@pytest.mark.parametrize("bound,prefilter,gamma,group,group_budget,noise", WALK_CASES)
def test_warp_walk_matches_plain(bound, prefilter, gamma, group, group_budget, noise):
    rng = np.random.default_rng(31)
    C = 1 if bound <= 1 else 2
    H = 32
    # dense inside a ball (rays overflow the budget there), sparse outside
    c = (np.arange(H) + 0.5) / H * 2 - 1
    r2 = sum(a**2 for a in np.meshgrid(c, c, c, indexing="ij"))
    frac = np.where(r2 < 0.5, 0.7, 0.02)
    occ = torch.from_numpy(rng.uniform(size=(C, H, H, H)) < frac)
    o, d = _rays(rng, 48, bound)
    aabb = (-bound,) * 3 + (bound,) * 3
    nz = torch.from_numpy(rng.uniform(size=48).astype(np.float32)) if noise else None
    n_cand = 96 if group == 3 else None
    kw = dict(min_near=0.2, bound=bound, dt_gamma=gamma, max_steps=128, budget=16,
              prefilter=prefilter, group=group, group_budget=group_budget, n_cand=n_cand,
              noise=nz)
    plan = t_march.march_plan(C, H, bound=bound, dt_gamma=gamma, max_steps=128,
                              n_cand=n_cand, budget=16, prefilter=prefilter, group=group,
                              group_budget=group_budget)
    assert plan.prefilter == prefilter
    e = warp_walk(o, d, aabb, occ, **kw)
    p = t_march.march_rays_aabb(o, d, aabb, occ, plain=True, **kw)
    for name in e:
        assert torch.equal(e[name], p[name]), name
    assert p["mask"].any()
    if group_budget is None:
        assert (p["n_occupied"] > 16).any()  # some rays overflow S
    else:
        assert (p["n_groups_occ"] > plan.group_budget).any()  # the budget truncates


def _density_grid(rng, C, H):
    """A float render grid: a dense ball of densities U(0, 300) (a few
    occupied cells at exactly 0, which count as empty), sparse outside."""
    c = (np.arange(H) + 0.5) / H * 2 - 1
    r2 = sum(a**2 for a in np.meshgrid(c, c, c, indexing="ij"))
    occ = rng.uniform(size=(C, H, H, H)) < np.where(r2 < 0.5, 0.7, 0.02)
    dens = rng.uniform(0.0, 300.0, size=occ.shape) * (rng.uniform(size=occ.shape) > 0.05)
    return torch.from_numpy(np.where(occ, dens, 0.0).astype(np.float32))


CULL_CASES = [(b, pf, g, tc) for b in (1.0, 2.0) for pf in (True, False)
              for g in (0.0, 1 / 128) for tc in (1e-3, 1e-5)]


@pytest.mark.parametrize("bound,prefilter,gamma,t_cull", CULL_CASES)
def test_warp_walk_cull_matches_plain(bound, prefilter, gamma, t_cull):
    """The float grid's walk with the cull: the running sum's warp scan and
    carry, the survivors' slots, n_occupied (survivors) apart from
    n_occupied_raw and n_groups_occ (pre-cull)."""
    rng = np.random.default_rng(47)
    C = 1 if bound <= 1 else 2
    grid = _density_grid(rng, C, 32)
    o, d = _rays(rng, 48, bound)
    aabb = (-bound,) * 3 + (bound,) * 3
    nz = torch.from_numpy(rng.uniform(size=48).astype(np.float32))
    kw = dict(min_near=0.2, bound=bound, dt_gamma=gamma, max_steps=128, budget=16,
              prefilter=prefilter, noise=nz, t_cull=t_cull)
    e = warp_walk(o, d, aabb, grid, **kw)
    p = t_march.march_rays_aabb(o, d, aabb, grid, plain=True, audit=True, **kw)
    margin = p.pop("cull_margin")
    p.pop("n_tested")
    assert int(margin.sum()) == 0, "rays at the cull's margin on these inputs"
    for name in e:
        assert torch.equal(e[name], p[name]), name
    # the cull bites, and the pre-cull counts do not see it
    assert (p["n_occupied"] < p["n_occupied_raw"]).any()
    exact = t_march.march_rays_aabb(o, d, aabb, grid, plain=True, **dict(kw, t_cull=0.0))
    assert torch.equal(exact["n_occupied_raw"], p["n_occupied_raw"])
    assert torch.equal(exact["n_groups_occ"], p["n_groups_occ"])
    assert torch.equal(exact["n_occupied"], exact["n_occupied_raw"])
