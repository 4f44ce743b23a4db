"""The clean trainer's auto group budget (``--group_budget -1``) in the two
packages, on the same draws: ``Trainer._adapt_group_budget`` (and the march
budget and compaction rules it runs beside) driven step by step by each
package's own march statistics, on the analytic ball.  The port must move
its adaptations at the same steps to the same values as the JAX package.

Both trainers see the same model, the same rays and pixels, and JAX's random
draws: each step's background and march noise (``kbg, kperturb =
split(key)``), and each grid update's jitter, cells and uniforms, handed to
the port as tensors.  Everything is fp32 on the CPU.

The JAX side updates its grid through ``jax_grid_update`` (a fresh density
closure on its current params): the JAX package's own ``update_extra_state``
keeps the params of its first update (ROADMAP queue 3), which the port does
not copy; ``test_grid_update_requeries_the_current_params`` pins that.

Run as a script, it shows that staleness, then compares the packages at a
cut size of the stall the port showed on the H100 (the radius-0.4 ball,
where the auto group budget falls to its floor of 16 groups): full-width
models, 128x128 views, the CLI's grid and march settings, and also the JAX
package with the static group budget, printing each run's trajectory, the
grids' occupied shares, last losses and held-out PSNR:

    JAX_PLATFORMS=cpu python tests/test_torch_group_budget.py [steps]
"""

import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # the test helpers, the repo root

from nerf_signature_tpu.api import NGPModel as JModel  # noqa: E402
from nerf_signature_tpu.models import ngp as j_ngp  # noqa: E402
from nerf_signature_tpu.ops import grid as j_grid  # noqa: E402
from nerf_signature_tpu.train import trainer as j_trainer  # noqa: E402
from nerf_signature_tpu_torch.api import NGPModel as TModel  # noqa: E402
from nerf_signature_tpu_torch.data.rays import get_rays, rand_poses  # noqa: E402
from nerf_signature_tpu_torch.models import ngp as t_ngp  # noqa: E402
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt  # noqa: E402
from nerf_signature_tpu_torch.train import trainer as t_trainer  # noqa: E402
from test_torch_render import _jax_draws  # noqa: E402
from test_torch_serve import ball_rgba  # noqa: E402

T = torch.from_numpy
ANGLE = 0.6911112070083618  # the Blender camera


def views(n, res, seed=5, radius=3.2):
    poses = rand_poses(np.random.default_rng(seed), n, radius=radius)
    fl = res / (2 * np.tan(ANGLE / 2))
    return poses, np.array([fl, fl, res / 2, res / 2])


def make_pair(ngp_kw, grid_size, max_steps, train_budget, group_budget, interval, iters,
              num_rays, with_port=True, seed=0):
    """JAX and port trainers on the same fp32 model (JAX's init)."""
    jcfg = j_ngp.NGPConfig(bound=1.0, compute_dtype=jnp.float32, **ngp_kw)
    tcfg = t_ngp.NGPConfig(bound=1.0, compute_dtype=torch.float32, **ngp_kw)
    kw = dict(min_near=0.2, density_thresh=10.0, dt_gamma=0.0, max_steps=max_steps,
              grid_size=grid_size, train_budget=train_budget, infer_budget=256)
    jm = JModel(jcfg, seed=seed, **kw)
    opt = types.SimpleNamespace(lr=1e-2, iters=iters, max_steps=max_steps, num_rays=num_rays,
                                update_extra_interval=interval, compact_frac=-1,
                                group_budget=group_budget, devices=1, patch_size=1,
                                max_ray_batch=4096)
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = None
    if with_port:
        tm = TModel(tcfg, device="cpu", **kw)
        tm.params = t_ckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
        tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch",
                               mute=True)
    return jt, tt


def jax_grid_update(jm, key):
    """JAX's ``update_occupancy_grid`` on the model's CURRENT params.  The
    JAX package's ``update_extra_state`` hands ``jax.jit`` its bound
    ``density_fn`` as a static argument: every update after the first hits
    the jit cache and reuses the program traced with the first update's
    params, so its grid never sees training (ROADMAP queue 3).  A fresh
    closure each update makes jit trace the current params."""
    params, cfg, rc = jm.params, jm.cfg, jm.rc
    return j_grid.update_occupancy_grid(
        jm.occ, key, lambda x: j_ngp.ngp_density(params, cfg, x)["sigma"],
        bound=rc.bound, grid_size=rc.grid_size, density_scale=rc.density_scale,
        density_thresh=jm.density_thresh, full=int(jm.occ.iter_density) < 16)


def run(jt, tt, radius, res, n_views, iters, seed=0, jax_grid="fresh"):
    """The clean train_one_epoch's order (grid update every ``interval``
    steps, the step, the three adaptations at ``interval - 1``), both
    packages in lockstep.  The grid updates draw JAX's numbers for both;
    ``jax_grid``: "fresh" (JAX updates its own grid on its current params,
    see ``jax_grid_update``) or "port" (JAX takes the port's grid: XLA
    contracts the grid's jittered positions into FMAs, so densities differ
    by ~1e-5 relative, and in the fog phase, where a fresh model's densities
    sit at the mean that sets the threshold, that flips cells).  Returns the
    per-step state of each, the losses and the grids' occupied shares after
    each update."""
    jm = jt.model
    interval = jt.opt.update_extra_interval
    poses, intr = views(n_views, res)
    jm.mark_untrained_grid(poses, intr)
    if tt is not None:
        tt.model.mark_untrained_grid(poses, intr)
    rng = np.random.default_rng(seed)
    state = lambda m: (m.train_budget, m.rc.compact_frac, m.rc.group_budget)
    traj_j, traj_t, loss_j, loss_t = [], [], [], []
    occupied = []  # (step, JAX grid's occupied share, the port's) after each update
    for step in range(iters):
        if step % interval == 0:
            key = jax.random.PRNGKey(10_000 + step)
            if tt is not None:
                tm = tt.model
                full = int(tm.occ.iter_density) < 16
                tm.update_extra_state(draws=_jax_draws(key, tm.occ.density.shape[0],
                                                       tm.rc.grid_size, full))
            if jax_grid == "port":
                jm.occ = jm.occ._replace(**{k: jnp.asarray(getattr(tm.occ, k).numpy())
                                            for k in tm.occ._fields})
            else:
                jm.occ = jax_grid_update(jm, key)
            if tt is not None:
                occupied.append((step, float(np.asarray(jm.occ.occupancy).mean()),
                                 float(tm.occ.occupancy.float().mean())))
        v = int(rng.integers(n_views))
        r = get_rays(poses[v:v + 1], intr, res, res, jt.opt.num_rays, rng=rng)
        ro, rd = r["rays_o"][0], r["rays_d"][0]
        images = ball_rgba(ro, rd, radius=radius)
        key = jax.random.PRNGKey(step)
        (jm.params, jt.ema_params, jt.opt_state, loss, _, n_occ, n_raw, n_groups
         ) = j_trainer._train_step(
            jm.params, jt.ema_params, jt.opt_state, jm.occ.occupancy, jnp.asarray(ro),
            jnp.asarray(rd), jnp.asarray(images), key, jm.cfg, jt._rc_train(),
            jm.train_budget, jt.optimizer.update, True, jt.ema_decay)
        outs = [(jt, np.asarray(n_raw), float(np.asarray(n_occ).mean()),
                 float(np.asarray(n_groups).mean()))]
        loss_j.append(float(loss))
        if tt is not None:
            kbg, kperturb = jax.random.split(key)
            bg = T(np.asarray(jax.random.uniform(kbg, (ro.shape[0], 3))))
            noise = T(np.asarray(jax.random.uniform(kperturb, (ro.shape[0],))))
            lt, _, t_occ, t_raw, t_groups = tt._train_step(
                T(ro), T(rd), T(images), bg, noise, tt._rc_train(), tt.model.train_budget)
            outs.append((tt, t_raw.numpy(), float(t_occ.float().mean()),
                         float(t_groups.float().mean())))
            loss_t.append(float(lt))
        if step % interval == interval - 1:
            for trainer, raw, occ_mean, groups in outs:
                trainer._adapt_budget(raw)
                trainer._adapt_compaction(occ_mean)
                trainer._adapt_group_budget(groups)
        traj_j.append(state(jm))
        if tt is not None:
            traj_t.append(state(tt.model))
    return traj_j, traj_t, loss_j, loss_t, occupied


def moves(traj):
    """(step, (budget, compaction, group budget)) where the state changed."""
    return [(i, s) for i, s in enumerate(traj) if i == 0 or s != traj[i - 1]]


def test_group_budget_trajectory_matches_jax():
    """A tiny model with a grid update every step: the group budget adapts
    once the grid's 16 full updates are done, and moves on the small ball;
    on the same grid (the port's, see ``run``) the port's march counts the
    same samples and groups, and it moves all three adaptations at the same
    steps to the same values as JAX.  Losses within 1e-4 relative (the gradients'
    summation order over 24 Adam steps)."""
    kw = dict(n_levels=4, log2_hashmap_size=12, hidden_dim=16, hidden_dim_color=16,
              finest_resolution=128)
    iters = 24
    jt, tt = make_pair(kw, grid_size=32, max_steps=256, train_budget=128, group_budget=-1,
                       interval=1, iters=iters, num_rays=256)
    traj_j, traj_t, loss_j, loss_t, _ = run(jt, tt, radius=0.4, res=32, n_views=4,
                                            iters=iters, jax_grid="port")
    assert traj_t == traj_j, (moves(traj_j), moves(traj_t))
    groups = {s[2] for s in traj_j}
    assert len(groups - {0}) >= 2 and min(groups - {0}) >= 16, moves(traj_j)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)


def _grid_pair():
    """A tiny JAX and port model pair for the grid-update checks."""
    kw = dict(n_levels=2, log2_hashmap_size=10, finest_resolution=128)
    jt, tt = make_pair(kw, grid_size=16, max_steps=128, train_budget=32, group_budget=-1,
                       interval=1, iters=2, num_rays=64)
    return jt.model, tt.model


def test_grid_update_requeries_the_current_params():
    """The port's ``update_extra_state`` queries the model's current params
    at every update: after the params change, its densities are those of
    JAX's ``update_occupancy_grid`` on the new params (rtol 1e-4, the FMA
    ulps of test_torch_render).  The JAX package's ``update_extra_state``
    would keep the first update's params (``jax_grid_update``); the port
    does not copy that."""
    jm, tm = _grid_pair()
    for i in range(2):
        if i:
            jm.params = dict(jm.params, hash_table=jm.params["hash_table"] * 1e4)
            with torch.no_grad():
                tm.params["hash_table"].mul_(1e4)
        key = jax.random.PRNGKey(i)
        tm.update_extra_state(draws=_jax_draws(key, 1, 16, True))
        jm.occ = jax_grid_update(jm, key)
    np.testing.assert_allclose(tm.occ.density.numpy(), np.asarray(jm.occ.density), rtol=1e-4)
    assert float(tm.occ.mean_density) > 1.5  # the new field's, not exp(~0) = 1


def stale_grid_demo():
    """The JAX package's update_extra_state against a fresh-closure update
    and the port, after a change of params between two updates."""
    jm, tm = _grid_pair()
    jm.update_extra_state()
    tm.update_extra_state()
    jm.params = dict(jm.params, hash_table=jm.params["hash_table"] * 1e4)
    with torch.no_grad():
        tm.params["hash_table"].mul_(1e4)
    before = jm.occ
    jm.update_extra_state()
    stale = float(jm.occ.mean_density)
    jm.occ = before
    fresh = float(jax_grid_update(jm, jax.random.PRNGKey(1)).mean_density)
    tm.update_extra_state()
    print(f"[stale grid] mean grid density after the params change: JAX update_extra_state "
          f"{stale:.6f}, JAX update_occupancy_grid on the current params {fresh:.6f}, "
          f"port {float(tm.occ.mean_density):.6f}", flush=True)


def held_out_psnr(jm, res, radius):
    poses, intr = views(1, res, seed=9)
    r = get_rays(poses, intr, res, res, -1)
    img = np.asarray(jm.render(jnp.asarray(r["rays_o"][0]), jnp.asarray(r["rays_d"][0]),
                               staged=True)["image"])
    rgba = ball_rgba(r["rays_o"][0], r["rays_d"][0], radius=radius)
    gt = rgba[:, :3] * rgba[:, 3:] + (1.0 - rgba[:, 3:])
    return -10 * np.log10(max(float(np.mean((img - gt) ** 2)), 1e-12))


def main(iters=512):
    """The cut-size comparison: full-width models (16 levels, 2^16 rows a
    level), 32 views of 128x128, 1024 rays a step, grid 128^3 with an update
    every 16 steps, max_steps 1024, budget 128, on the radius-0.4 ball."""
    kw = dict(log2_hashmap_size=16)
    common = dict(grid_size=128, max_steps=1024, train_budget=128, interval=16, iters=iters,
                  num_rays=1024)
    stale_grid_demo()
    t0 = time.time()
    jt, tt = make_pair(kw, group_budget=-1, **common)
    traj_j, traj_t, loss_j, loss_t, occupied = run(jt, tt, 0.4, 128, 32, iters)
    print(f"[auto, both] {time.time() - t0:.0f} s; trajectories equal: {traj_j == traj_t}")
    print(f"[auto, JAX ] moves (step, (budget, compaction, group budget)): {moves(traj_j)}")
    print(f"[auto, port] moves: {moves(traj_t)}")
    print("[auto] occupied share of the grid after the first updates (step, JAX, port): "
          + ", ".join(f"({s}, {a:.4f}, {b:.4f})" for s, a, b in occupied[:8]))
    print(f"[auto] mean loss of the last 64 steps: JAX {np.mean(loss_j[-64:]):.6f}, "
          f"port {np.mean(loss_t[-64:]):.6f}; held-out PSNR (JAX model) "
          f"{held_out_psnr(jt.model, 128, 0.4):.2f} dB", flush=True)
    jt0, _ = make_pair(kw, group_budget=0, with_port=False, **common)
    traj_0, _, loss_0, _, _ = run(jt0, None, 0.4, 128, 32, iters)
    print(f"[static, JAX] moves: {moves(traj_0)}")
    print(f"[static, JAX] mean loss of the last 64 steps {np.mean(loss_0[-64:]):.6f}; "
          f"held-out PSNR {held_out_psnr(jt0.model, 128, 0.4):.2f} dB; "
          f"{time.time() - t0:.0f} s in all", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 512)
