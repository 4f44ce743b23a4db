"""Port parity of the transmittance cull (``--t_cull``): the float render
grid's march (K2's cull route; its plain version on the CPU) against JAX's
``march_rays``, the pre-cull counts, the fog gate and the device loop's one
recapture when it opens, the exact renders, the stale-spike case of
``tests/test_t_cull.py``, and a clean step and the clean device loop with
the cull against JAX's on the same draws.

Tolerances and why (fp32, the CPU):
  * the march: masks and the three counts equal; ts, deltas and xyzs
    within 1e-6 (XLA contracts ``t0 + i*dt`` and ``o + t*d`` into FMAs,
    ROADMAP queue 3).  The running sum of tau is taken in another order by
    each package (XLA's cumsum in fp32, torch's on the CPU in fp64), so a
    candidate whose entering transmittance lies within ``CULL_MARGIN``
    (1e-5 relative) of t_cull could be kept by one and culled by the
    other: such rays are counted, and none are on these inputs.
  * a step and the loop: as ``tests/test_torch_device_loop.py`` (losses
    1e-5 relative; params 1e-4, EMA 1e-5 relative L2; the statistics 1e-6).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.ops import grid as j_grid
from nerf_signature_tpu.ops import intersect as j_int
from nerf_signature_tpu.ops import marching as j_march
from nerf_signature_tpu.train import device_loop as j_dl
from nerf_signature_tpu.train import trainer as j_trainer
from nerf_signature_tpu_torch.ops import grid as t_grid
from nerf_signature_tpu_torch.ops import marching as t_march
from nerf_signature_tpu_torch.train import device_loop as t_dl
from nerf_signature_tpu_torch.train import trainer as t_trainer
from test_torch_device_loop import (BUDGET, LEAVES, N_RAYS, N_STEPS, P, H, W, _clean_opt,
                                    _leaves_j, _leaves_t, _views, jax_clean_draws)
from test_torch_ops import _assert_march_equal, _march_setup
from test_torch_render import H_GRID, make_models
from test_torch_train_ops import rel_l2

T = torch.from_numpy


def _density_grid(occ, seed):
    """The float render grid of occupancy ``occ``: densities U(0.5, 400),
    a few occupied cells at exactly 0 (empty to the march, as in JAX)."""
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0.5, 400.0, size=occ.shape) * (rng.uniform(size=occ.shape) > 0.05)
    return np.where(occ, dens, 0.0).astype(np.float32)


MARCH_CASES = [  # (bound, prefilter, dt_gamma, group_budget)
    (1.0, False, 0.0, None), (1.0, True, 0.0, None), (2.0, True, 1 / 128, 8),
    (2.0, False, 1 / 128, None)]


@pytest.mark.parametrize("t_cull", [1e-3, 1e-5])
@pytest.mark.parametrize("bound,prefilter,gamma,group_budget", MARCH_CASES)
def test_march_on_the_float_grid_matches_jax(bound, prefilter, gamma, group_budget, t_cull):
    occ, o, d, aabb = _march_setup(bound, seed=9, frac=0.15)
    grid = _density_grid(occ, seed=10)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.uniform(key, (o.shape[0],), dtype=jnp.float32))
    kw = dict(bound=bound, dt_gamma=gamma, max_steps=128, budget=32, prefilter=prefilter,
              group_budget=group_budget, t_cull=t_cull)
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.2)
    mj = j_march.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(grid), nj, fj,
                            grid_size=grid.shape[1], perturb_key=key, **kw)
    mt = t_march.march_rays_aabb(T(o), T(d), aabb, T(grid), min_near=0.2, noise=T(noise),
                                 audit=True, **kw)
    assert int(mt["cull_margin"].sum()) == 0, "rays at the cull's margin on these inputs"
    _assert_march_equal(mj, mt)
    # the cull bites; the raw count and the group count are the pre-cull ones
    assert (mt["n_occupied"] < mt["n_occupied_raw"]).any()
    exact = t_march.march_rays_aabb(T(o), T(d), aabb, T(grid), min_near=0.2, noise=T(noise),
                                    **dict(kw, t_cull=0.0))
    for k in ("n_occupied_raw", "n_groups_occ"):
        assert torch.equal(exact[k], mt[k]), k
    # the bool grid of the same cells marches like the float grid at t_cull 0
    boolean = t_march.march_rays_aabb(T(o), T(d), aabb, T(grid > 0), min_near=0.2,
                                      noise=T(noise), **dict(kw, t_cull=0.0))
    for k in ("mask", "ts", "n_occupied", "n_groups_occ"):
        assert torch.equal(boolean[k], exact[k]), k


def test_float_grid_counts_an_occupied_zero_density_cell_as_empty():
    """A cell occupied in the bool grid with a live density of 0 is empty on
    the float grid, in both packages."""
    occ, o, d, aabb = _march_setup(1.0, seed=12, frac=0.3)
    grid = np.where(occ, 5.0, 0.0).astype(np.float32)
    grid[0, :, :16] = 0.0  # half the occupied cells at density 0
    kw = dict(bound=1.0, max_steps=128, budget=32, prefilter=False, t_cull=1e-5)
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.2)
    mj = j_march.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(grid), nj, fj,
                            grid_size=32, **kw)
    mt = t_march.march_rays_aabb(T(o), T(d), aabb, T(grid), min_near=0.2, **kw)
    on_bool = t_march.march_rays_aabb(T(o), T(d), aabb, T(occ), min_near=0.2,
                                      **dict(kw, t_cull=0.0))
    _assert_march_equal(mj, mt)
    assert (mt["n_occupied_raw"] < on_bool["n_occupied_raw"]).any()


def _grid_with_densities(m, seed, iter_density=16):
    """A grid past the fog gate on a model of either package: densities
    U(20, 200) in the ball of the test models' occupancy, 0 outside."""
    occ = np.asarray(m.occ.occupancy)
    if isinstance(m.occ.occupancy, torch.Tensor):
        occ = m.occ.occupancy.numpy()
    rng = np.random.default_rng(seed)
    dens = np.where(occ, rng.uniform(20.0, 200.0, size=occ.shape), 0.0).astype(np.float32)
    return dens.reshape(occ.shape[0], -1), occ, iter_density


def _set_grid(m, dens, occ, iter_density, port):
    if port:
        m.occ = m.occ._replace(density=T(dens.copy()), density_live=T(dens.copy()),
                               occupancy=T(occ.copy()),
                               mean_density=torch.tensor(float(dens.mean())),
                               iter_density=torch.tensor(iter_density, dtype=torch.int32))
    else:
        m.occ = m.occ._replace(density=jnp.asarray(dens), density_live=jnp.asarray(dens),
                               occupancy=jnp.asarray(occ),
                               mean_density=jnp.float32(dens.mean()),
                               iter_density=jnp.int32(iter_density))


def test_clean_step_with_the_cull_matches_jax():
    """One train step past the fog gate (the float render grid, t_cull 1e-3)
    on JAX's draws: loss, per-ray errors and the counts."""
    from test_torch_train import batch, draws

    jm, tm = make_models("fp32", 1.0)
    dens, occ, it = _grid_with_densities(tm, seed=3)
    _set_grid(jm, dens, occ, it, port=False)
    _set_grid(tm, dens, occ, it, port=True)
    for m in (jm, tm):
        m.rc = dataclasses.replace(m.rc, t_cull=1e-3)
    opt = _clean_opt(num_rays=256)
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    ro, rd, images = batch(seed=1)
    key = jax.random.PRNGKey(13)
    rc_j, rc_t = jt._rc_train(), tt._rc_train()
    assert rc_j.t_cull == rc_t.t_cull == 1e-3
    (_, _, _, lj, prj, *cj) = j_trainer._train_step(
        jm.params, jt.ema_params, jt.opt_state, j_grid.render_grid(jm.occ, rc_j.t_cull),
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(images), key, jm.cfg, rc_j, 32,
        jt.optimizer.update, True, jt.ema_decay)
    _, bg, noise = draws(key, ro.shape[0])
    lt, prt, *ct = tt._train_step(T(ro), T(rd), T(images), T(bg), T(noise), rc_t, 32)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    np.testing.assert_allclose(prt.numpy(), np.asarray(prj), rtol=1e-4, atol=1e-7)
    for a, b in zip(cj, ct):
        assert np.array_equal(np.asarray(a), b.numpy())
    n_occ, n_raw = ct[0].numpy(), ct[1].numpy()
    assert (n_occ < n_raw).any()  # the cull bites


@pytest.fixture(scope="module")
def cull_loop_runs():
    """JAX's ``device_train_loop`` and the port's, with the cull on from
    step 0 (the grid past the fog gate, partial updates at steps 0 and 16)
    on the same draws."""
    jm, tm = make_models("fp32", 1.0, budget=BUDGET)
    dens, occ, it = _grid_with_densities(tm, seed=5)
    _set_grid(jm, dens, occ, it, port=False)
    _set_grid(tm, dens, occ, it, port=True)
    for m in (jm, tm):
        m.rc = type(m.rc)(**{**m.rc.__dict__, "compact_frac": 0.5, "t_cull": 1e-3})
        m.train_budget = BUDGET
        m.density_thresh = 5.0
    opt = _clean_opt()
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    poses, images, intr = _views(4)
    key = jax.random.PRNGKey(17)
    out = j_dl.device_train_loop(
        jm.params, jt.ema_params, jt.opt_state, jm.occ, jnp.asarray(poses),
        jnp.asarray(images.reshape(P, -1, 4)), jnp.asarray(intr), key, 0, jt.cfg_train,
        jt._rc_train(), BUDGET, jt.optimizer.update, True, jt.ema_decay, N_STEPS, N_RAYS, H, W,
        update_interval=16, density_thresh=jm.density_thresh, grid_full_until=16)
    C_cas = tm.occ.density.shape[0]
    draws, grid = jax_clean_draws(key, N_STEPS, C_cas, {0: False, 16: False})
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    stats = t_dl.device_train_loop(tt, data, N_STEPS, draws=draws,
                                   grid_draws=lambda step, full: grid[step])
    return out, tm, tt, stats


def test_cull_loop_losses_and_statistics_match_jax(cull_loop_runs):
    out, _, tt, stats = cull_loop_runs
    np.testing.assert_allclose(stats.losses, np.asarray(out[4]), rtol=1e-5)
    _, _, _, _, _, mean_occ, _, p95, mean_groups, mean_raw = out
    for a, b in ((stats.mean_occupied, mean_occ), (stats.occ_p95, p95),
                 (stats.mean_groups_occ, mean_groups), (stats.mean_occupied_raw, mean_raw)):
        assert a == pytest.approx(float(b), rel=1e-6)
    # the cull bit: fewer survivors than occupied candidates on average
    assert stats.mean_occupied < stats.mean_occupied_raw
    assert tt.grid_updates == 18


def test_cull_loop_params_and_grid_match_jax(cull_loop_runs):
    out, tm, tt, _ = cull_loop_runs
    for name, pj, pt in zip(LEAVES, _leaves_j(out[0]), _leaves_t(tm.params)):
        assert rel_l2(pt, pj) <= 1e-4, name
    for ej, et in zip(_leaves_j(out[1]), _leaves_t(tt.ema_params)):
        assert rel_l2(et, ej) <= 1e-5
    gj = out[3]
    np.testing.assert_allclose(tm.occ.density_live.numpy(), np.asarray(gj.density_live),
                               rtol=1e-4, atol=1e-6)


class _CountingGraph:
    """What ``StepGraph`` does with its key and held objects, run on the
    CPU: a capture whenever either changes, then the steps eagerly."""

    def __init__(self):
        self.captures, self.key, self.held = 0, None, ()

    def run(self, owner, body, key, held, n, device, before_step=None):
        if self.key != key or len(held) != len(self.held) or any(
                a is not b for a, b in zip(held, self.held)):
            self.captures += 1
            self.key, self.held = key, tuple(held)
        for j in range(n):
            if before_step is not None:
                before_step(j)
            body()


def test_fog_gate_opens_once_and_the_loop_step_recaptures_once(monkeypatch):
    """The gate opens between dispatches (``_rc_train`` at a dispatch's
    start): the step's march changes route from the bool grid to the float
    render grid, so the loop's graph key changes and the step is captured
    again, exactly once; every later dispatch replays the cull."""
    _, tm = make_models("fp32", 1.0, budget=BUDGET)
    dens, occ, _ = _grid_with_densities(tm, seed=7)
    _set_grid(tm, dens, occ, 15, port=True)
    tm.rc = dataclasses.replace(tm.rc, t_cull=1e-3)
    tm.train_budget = BUDGET
    tt = t_trainer.Trainer("ngp", _clean_opt(), tm, workspace=None, use_checkpoint="scratch",
                           mute=True)
    graph = _CountingGraph()
    monkeypatch.setattr(t_dl, "run_steps", graph.run)
    grids = []
    render_grid = t_trainer.render_grid

    def spy(g, t_cull=0.0):
        out = render_grid(g, t_cull)
        grids.append(out.dtype)
        return out

    monkeypatch.setattr(t_trainer, "render_grid", spy)
    poses, images, intr = _views(4)
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    t_dl.prepare_device_loop(tt, t_trainer.param_leaves(tm.params))
    K = 4
    for d in range(4):
        tt.global_step = d * K
        t_dl.device_train_loop(tt, data, K, update_interval=16)
    # the update before step 0 made 16: dispatch 0 marched exact, 1-3 culled
    assert int(tm.occ.iter_density) == 16
    assert grids == [torch.bool] * K + [torch.float32] * 3 * K
    assert graph.captures == 2


def test_renders_stay_exact_with_t_cull():
    """Evaluation, test, pseudo-GT and probe renders use ``rc_eval`` (t_cull
    0, the bool grid), in both packages: a render with --t_cull is the
    render without it."""
    from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
    from test_torch_render import view_rays
    from test_torch_wm_train import make_wm_models

    jm, tm = make_models("fp32", 1.0)
    dens, occ, it = _grid_with_densities(tm, seed=9)
    _set_grid(tm, dens, occ, it, port=True)
    rays = view_rays(1.0, n=1, res=12)
    ref = tm.render(rays["rays_o"][0], rays["rays_d"][0])["image"]
    tm.rc = dataclasses.replace(tm.rc, t_cull=1e-2)
    tm.rc_eval = dataclasses.replace(tm.rc, t_cull=0.0)
    assert torch.equal(tm.render(rays["rays_o"][0], rays["rays_d"][0])["image"], ref)
    from nerf_signature_tpu_torch.api import NGPModel

    m = NGPModel(tm.cfg, grid_size=H_GRID, device="cpu", t_cull=1e-5)
    jm2 = type(jm)(jm.cfg, grid_size=H_GRID, t_cull=1e-5)
    assert m.rc.t_cull == jm2.rc.t_cull == 1e-5
    assert m.rc_eval.t_cull == jm2.rc_eval.t_cull == 0.0
    _, wm = make_wm_models("fp32")
    wm.rc = dataclasses.replace(wm.rc, t_cull=1e-5)
    opt = types.SimpleNamespace(seed=0, iters=10, lr=1e-2, lambda_w=0.5, lambda_i=1.0,
                                loss_w="bce", distortion="none", message_dim=3, devices=1,
                                num_rays=32, max_ray_batch=4096, compact_frac=0,
                                group_budget=0)
    wt = t_twm.WatermarkTrainer("wm", opt, wm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    assert wt._rc_eval().t_cull == 0.0


def test_stale_spike_in_decayed_max_does_not_poison_live_proxy():
    """``tests/test_t_cull.py``'s regression on the port: a spike kept in
    the decayed-max ``density`` but not in ``density_live`` culls nothing
    behind it; the old proxy (the decayed max) does."""
    H, bound = 32, 1.0
    spike_cell = ((6 * H) + H // 2) * H + H // 2

    def density_fn(x):
        return torch.where(torch.abs(x[:, 0] + 0.5) < 0.1, 2.0, 0.0)

    gen = torch.Generator().manual_seed(0)
    g = t_grid.init_occupancy_grid(bound, H)
    for _ in range(3):
        g = t_grid.update_occupancy_grid(g, density_fn, bound=bound, grid_size=H,
                                         density_thresh=0.01, full=True, generator=gen)
    g = g._replace(density=g.density.clone())
    g.density[0, spike_cell] = float(np.exp(54))
    o = torch.tensor([[-1.0, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0]])
    kw = dict(min_near=0.05, bound=bound, t_cull=1e-5, prefilter=False)
    aabb = (-bound,) * 3 + (bound,) * 3
    out = t_march.march_rays_aabb(o, d, aabb, t_grid.render_grid(g, 1e-5), **kw)
    n_live, n_raw = int(out["n_occupied"][0]), int(out["n_occupied_raw"][0])
    assert n_raw > 0 and n_live == n_raw, (n_live, n_raw)
    g_old = g._replace(density_live=g.density)
    out_old = t_march.march_rays_aabb(o, d, aabb, t_grid.render_grid(g_old, 1e-5), **kw)
    assert int(out_old["n_occupied"][0]) < n_raw
