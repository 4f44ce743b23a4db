"""Port parity of the on-device K-step train loops (``--steps_per_dispatch``):
``rays_from_pixels``, the clean ``device_train_loop`` and the watermark
``wm_device_loop`` against the JAX package's loops on JAX's own draws, the
port's loop against K per-step ``_train_step`` calls, the trainers'
``train_device`` through both CLIs (checkpoints JAX loads), and the grid
update's sync-free form.  CPU: the plain versions of the kernels, the same
step run eagerly (a CUDA graph replays it on the card).

The draws are JAX's: per step ``kg, kp, ki, kbg, kpert = split(k, 5)`` (the
watermark loop: ``km, kp, ki, kd = split(k, 4)``), handed to the port's
draw buffers, and the grid update's draws from ``kg`` as
``test_torch_render._jax_draws`` replicates them.

Tolerances and why (fp32; relative L2 per leaf; measured on the CPU):
  * ``rays_from_pixels``: origins equal; directions within 2e-7 (a 3 x 3
    product summed in another order).
  * clean loop, 18 steps with grid updates at steps 0 and 16 (full, JAX's
    ``kg`` draws): each package marches, and XLA on the CPU contracts
    ``t0 + i*dt``, ``o + t*d`` and the grid's jittered cell positions into
    FMAs where the port rounds each product (ROADMAP queue 3), so sample
    positions differ by an ulp; Adam (eps 1e-15) makes a step of about lr
    from any gradient, so an entry whose gradient sits at those ulps can step
    the other way.  Measured: losses 1.9e-7 relative, params <= 5.3e-6, EMA
    <= 8.1e-7, Adam's first moment <= 2.3e-4 and second <= 1.5e-5, grid
    densities 3.8e-5 relative, no occupancy bit apart, the statistics equal.
    Bounds: losses 1e-5; params 1e-4, EMA 1e-5, first moment 2e-3, second
    2e-4; densities rtol 1e-4 (atol 1e-6) and the bitfield equal away from
    the threshold; statistics 1e-6.
  * watermark loop, 4 steps with the noise distortion: step 0 agrees to
    1e-7, and then the decoder's batch norms and the BCE at temperature 10
    carry the same Adam sign flips much further: measured losses 1e-7,
    2e-6, 1.4e-4, 2.4e-5 relative at steps 0-3; message tables 4.3e-3,
    decoder weights <= 3.6e-3.  Bounds: the first two steps 1e-5, the others
    1e-3; leaves 1e-2.  A conv bias before a batch norm has a zero gradient
    in exact arithmetic, so Adam moves it by about lr a step in a direction
    set by rounding in either package: those leaves are held to moving at
    most lr a step from the same start.
  * the port's loop against its per-step path: the same ops on the same
    inputs, so bit-equal (``torch.equal``) on the CPU.
"""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nerf_signature_tpu.train import device_loop as j_dl
from nerf_signature_tpu.train import trainer as j_trainer
from nerf_signature_tpu.train import trainer_wtmk as j_twm
from nerf_signature_tpu_torch.data.rays import rand_poses
from nerf_signature_tpu_torch.ops import grid as t_grid
from nerf_signature_tpu_torch.train import device_loop as t_dl
from nerf_signature_tpu_torch.train import trainer as t_trainer
from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
from test_torch_render import H_GRID, _jax_draws, make_models
from test_torch_train_ops import rel_l2
from test_torch_wm_train import make_wm_models, wm_batch

T = torch.from_numpy
LEAVES = ["hash_table", "sigma_net.0", "sigma_net.1", "color_net.0", "color_net.1",
          "color_net.2"]
P, H, W = 4, 16, 16
N_RAYS = 64
BUDGET = 32
N_STEPS = 18
DENSITY_THRESH = 5.0  # prunes part of the grid (the tests' 0.01 keeps every cell)


def _views(C, seed=0):
    rng = np.random.default_rng(seed)
    poses = rand_poses(rng, P, radius=2.2).astype(np.float32)
    images = rng.uniform(size=(P, H, W, C)).astype(np.float32)
    intr = np.array([18.0, 18.0, 8.0, 8.0], np.float32)
    return poses, images, intr


def _clean_opt(**kw):
    d = dict(lr=1e-2, iters=100, max_ray_batch=128, devices=1, patch_size=1,
             num_rays=N_RAYS, max_steps=128, compact_frac=0.5, group_budget=0,
             update_extra_interval=16, save_interval=1)
    d.update(kw)
    return types.SimpleNamespace(**d)


def jax_clean_draws(key, n_steps, C_cas, full_of_step):
    """The port's draw buffers and grid draws from the keys JAX's loop
    splits (``device_loop.py``'s body)."""
    pidx, pix, bg, noise, grid = [], [], [], [], {}
    for step, k in enumerate(jax.random.split(key, n_steps)):
        kg, kp, ki, kbg, kpert = jax.random.split(k, 5)
        pidx.append(int(jax.random.randint(kp, (), 0, P)))
        pix.append(np.asarray(jax.random.randint(ki, (N_RAYS,), 0, H * W)))
        bg.append(np.asarray(jax.random.uniform(kbg, (N_RAYS, 3))))
        noise.append(np.asarray(jax.random.uniform(kpert, (N_RAYS,))))
        if step in full_of_step:
            grid[step] = _jax_draws(kg, C_cas, H_GRID, full_of_step[step])
    draws = t_dl.CleanDraws(torch.tensor(pidx), T(np.stack(pix).astype(np.int64)),
                            T(np.stack(bg)), T(np.stack(noise)))
    return draws, grid


@pytest.fixture(scope="module")
def clean_runs():
    """JAX's ``device_train_loop`` and the port's on the same draws, from the
    same params: (jm, jt, jax outputs, tm, tt, port stats)."""
    jm, tm = make_models("fp32", 1.0, budget=BUDGET)
    for m in (jm, tm):
        m.rc = type(m.rc)(**{**m.rc.__dict__, "compact_frac": 0.5})
        m.train_budget = BUDGET
        m.density_thresh = DENSITY_THRESH
    opt = _clean_opt()
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    poses, images, intr = _views(4)
    key = jax.random.PRNGKey(7)
    out = j_dl.device_train_loop(
        jm.params, jt.ema_params, jt.opt_state, jm.occ, jnp.asarray(poses),
        jnp.asarray(images.reshape(P, -1, 4)), jnp.asarray(intr), key, 0, jt.cfg_train,
        jt._rc_train(), BUDGET, jt.optimizer.update, True, jt.ema_decay, N_STEPS, N_RAYS, H, W,
        update_interval=16, density_thresh=jm.density_thresh, grid_full_until=16)
    C_cas = tm.occ.density.shape[0]
    draws, grid = jax_clean_draws(key, N_STEPS, C_cas, {0: True, 16: True})
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    stats = t_dl.device_train_loop(tt, data, N_STEPS, draws=draws,
                                   grid_draws=lambda step, full: grid[step])
    return jm, jt, out, tm, tt, stats


def test_clean_loop_linear_color_space_matches_jax(monkeypatch):
    """``--color_space linear`` through both trainers' ``train_device``: both
    loops train on the loader's images as they are, with no sRGB-to-linear
    conversion (the per-step path converts; ROADMAP queue 3 records the
    shared behaviour), and 4 steps on JAX's draws agree within the clean
    loop's bounds."""
    jm, tm = make_models("fp32", 1.0, budget=BUDGET)
    for m in (jm, tm):
        m.train_budget = BUDGET
    opt = _clean_opt(color_space="linear", compact_frac=0)
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    poses, images, intr = _views(3, seed=2)
    loader = types.SimpleNamespace(poses=poses, images=images, intrinsics=intr, H=H, W=W)
    seen = {}
    real_j, real_t = j_dl.device_train_loop, t_trainer.device_train_loop

    def jax_loop(*args, **kw):
        seen["jax_images"], seen["key"] = np.asarray(args[5]), args[7]
        return real_j(*args, **kw)

    monkeypatch.setattr(j_dl, "device_train_loop", jax_loop)
    jt.train_device(loader, 4, steps_per_dispatch=4)
    C_cas = tm.occ.density.shape[0]
    draws, grid = jax_clean_draws(seen["key"], 4, C_cas, {0: True})
    draws = draws._replace(bg=None)  # RGB views: white, no background draw

    def port_loop(trainer, data, k, **kw):
        seen["port_images"] = data.images.numpy()
        return real_t(trainer, data, k, draws=draws, grid_draws=lambda step, full: grid[step],
                      **kw)

    monkeypatch.setattr(t_trainer, "device_train_loop", port_loop)
    tt.train_device(loader, 4, steps_per_dispatch=4)
    raw = images.reshape(P, -1, 3)
    assert np.array_equal(seen["jax_images"], raw) and np.array_equal(seen["port_images"], raw)
    np.testing.assert_allclose(tt.stats["loss"], jt.stats["loss"], rtol=1e-5)
    for a, b in zip(_leaves_t(tm.params), _leaves_j(jm.params)):
        assert rel_l2(a, b) <= 1e-4


def _leaves_j(tree):
    return [np.asarray(tree["hash_table"])] + [np.asarray(w) for w in tree["sigma_net"]] + [
        np.asarray(w) for w in tree["color_net"]]


def _leaves_t(tree):
    return [t.detach().numpy() for t in t_trainer.param_leaves(tree)]


def test_rays_from_pixels_matches_jax():
    poses, _, intr = _views(3, seed=4)
    pix = np.random.default_rng(1).integers(0, H * W, 500)
    for pose in poses:
        oj, dj = j_dl.rays_from_pixels(jnp.asarray(pose), tuple(jnp.asarray(intr)),
                                       jnp.asarray(pix), H, W)
        ot, dt = t_dl.rays_from_pixels(T(pose), T(intr), T(pix), H, W)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=2e-7)


def test_clean_loop_losses_match_jax(clean_runs):
    *_, out, _, _, stats = clean_runs
    lj = np.asarray(out[4])
    assert stats.losses.shape == (N_STEPS,)
    np.testing.assert_allclose(stats.losses, lj, rtol=1e-5)


def test_clean_loop_params_and_ema_match_jax(clean_runs):
    jm, jt, out, tm, tt, _ = clean_runs
    for name, pj, pt in zip(LEAVES, _leaves_j(out[0]), _leaves_t(tm.params)):
        assert rel_l2(pt, pj) <= 1e-4, name
    for ej, et in zip(_leaves_j(out[1]), _leaves_t(tt.ema_params)):
        assert rel_l2(et, ej) <= 1e-5


def test_clean_loop_adam_state_matches_jax(clean_runs):
    _, _, out, tm, tt, _ = clean_runs
    adam = out[2][0]
    assert tt.opt_count() == int(adam.count) == N_STEPS
    leaves = t_trainer.param_leaves(tm.params)
    for key, tree, bound in (("exp_avg", adam.mu, 2e-3), ("exp_avg_sq", adam.nu, 2e-4)):
        for p, mj in zip(leaves, _leaves_j(tree)):
            assert rel_l2(tt.optimizer.state[p][key].numpy(), mj) <= bound, key


def test_clean_loop_grid_matches_jax(clean_runs):
    jm, _, out, tm, tt, _ = clean_runs
    gj, gt = out[3], tm.occ
    assert int(gt.iter_density) == int(gj.iter_density) == 2 == tt.grid_updates
    dj = np.asarray(gj.density)
    np.testing.assert_allclose(gt.density.numpy(), dj, rtol=1e-4, atol=1e-6)
    thresh = min(float(gj.mean_density), jm.density_thresh)
    away = np.abs(dj - thresh) > 1e-4 * abs(thresh) + 1e-6
    C = dj.shape[0]
    occ_j = np.asarray(gj.occupancy).reshape(C, -1)
    assert np.array_equal(gt.occupancy.numpy().reshape(C, -1)[away], occ_j[away])
    assert 0.0 < occ_j.mean() < 1.0


def test_clean_loop_statistics_match_jax(clean_runs):
    *_, out, _, _, stats = clean_runs
    _, _, _, _, _, mean_occ, _, p95, mean_groups, mean_raw = out
    for a, b in ((stats.mean_occupied, mean_occ), (stats.occ_p95, p95),
                 (stats.mean_groups_occ, mean_groups), (stats.mean_occupied_raw, mean_raw)):
        assert a == pytest.approx(float(b), rel=1e-6)
    assert stats.mean_occupied > 0


def test_clean_loop_equals_its_per_step_path():
    """The loop against K ``_train_step`` calls on the same draws (rays from
    ``rays_from_pixels``, the grid updated before steps 0 and 16 with the
    same draws): bit-equal on the CPU."""
    runs = []
    poses, images, intr = _views(4, seed=2)
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    gen = torch.Generator().manual_seed(3)
    draws = t_dl.draw_clean(gen, N_STEPS, P, N_RAYS, H * W, True, "cpu")
    grid = {s: t_grid.draw_grid_randomness(gen, 1, H_GRID, True, "cpu") for s in (0, 16)}
    for per_step in (False, True):
        _, tm = make_models("fp32", 1.0, budget=BUDGET)
        tm.rc = type(tm.rc)(**{**tm.rc.__dict__, "compact_frac": 0.5})
        tm.train_budget = BUDGET
        tt = t_trainer.Trainer("ngp", _clean_opt(), tm, workspace=None,
                               use_checkpoint="scratch", mute=True)
        if per_step:
            losses = []
            for s in range(N_STEPS):
                if s in grid:
                    tm.update_extra_state(draws=grid[s])
                pidx = int(draws.pidx[s])
                ro, rd = t_dl.rays_from_pixels(data.poses[pidx], data.intrinsics,
                                               draws.pix[s], H, W)
                loss = tt._train_step(ro, rd, data.images[pidx][draws.pix[s]], draws.bg[s],
                                      draws.noise[s], tm.rc, BUDGET)[0]
                losses.append(float(loss))
        else:
            losses = t_dl.device_train_loop(tt, data, N_STEPS, draws=draws,
                                            grid_draws=lambda s, full: grid[s]).losses
        runs.append((np.asarray(losses, np.float32), tm, tt))
    (la, ma, ta), (lb, mb, tb) = runs
    assert np.array_equal(la, lb)
    for a, b in zip(t_trainer.param_leaves(ma.params) + t_trainer.param_leaves(ta.ema_params),
                    t_trainer.param_leaves(mb.params) + t_trainer.param_leaves(tb.ema_params)):
        assert torch.equal(a, b)
    assert torch.equal(ma.occ.density, mb.occ.density)


# ------------------------------------------------------------------ watermark
WM_STEPS = 4
WM_RAYS = 32


def _wm_opt(**kw):
    d = dict(seed=0, iters=100, lr=1e-2, lambda_w=0.5, lambda_i=1.0, loss_w="bce",
             distortion="noise", message_dim=3, devices=1, num_rays=WM_RAYS,
             max_ray_batch=4096, compact_frac=0, group_budget=0, bitacc_batch=4)
    d.update(kw)
    return types.SimpleNamespace(**d)


@pytest.fixture(scope="module")
def wm_runs():
    jm, tm = make_wm_models("fp32")
    opt = _wm_opt()
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    ro_b, rd_b, *_ = wm_batch(seed=3)
    poses, images, intr = _views(3, seed=5)
    key = jax.random.PRNGKey(21)
    D = tm.wcfg.message_dim
    (jtr, _, lj, lwj, lij) = j_twm._wm_device_loop(
        jm.backbone, jm.trainable, jt.opt_state, jm.occ.occupancy, jnp.asarray(ro_b),
        jnp.asarray(rd_b), jnp.asarray(poses), jnp.asarray(images.reshape(P, -1, 3)),
        jnp.asarray(intr), key, jnp.float32(opt.lambda_w), jnp.float32(opt.lambda_i),
        jt.wcfg_train, jm.rc, jt.content_budget, jm.infer_budget, jt.optimizer.update,
        "noise", "bce", WM_STEPS, WM_RAYS, H, W)
    msg, pidx, pix, dist = [], [], [], []
    shape = t_twm.view_batch_shape(ro_b.shape)
    for k in jax.random.split(key, WM_STEPS):
        km, kp, ki, kd = jax.random.split(k, 4)
        msg.append(np.asarray(jax.random.randint(km, (D,), 0, 2)))
        pidx.append(int(jax.random.randint(kp, (), 0, P)))
        pix.append(np.asarray(jax.random.randint(ki, (WM_RAYS,), 0, H * W)))
        dist.append(np.asarray(jax.random.normal(kd, shape)))
    draws = t_dl.WmDraws(T(np.stack(msg).astype(np.int32)), torch.tensor(pidx),
                         T(np.stack(pix).astype(np.int64)), T(np.stack(dist)))
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    lt, lwt, lit = t_dl.wm_device_loop(tt, data, T(np.ascontiguousarray(ro_b)),
                                       T(np.ascontiguousarray(rd_b)), WM_STEPS, draws=draws)
    return (np.asarray(lj), np.asarray(lwj), np.asarray(lij), jtr), (lt, lwt, lit, tm)


def test_wm_loop_losses_match_jax(wm_runs):
    (lj, lwj, lij, _), (lt, lwt, lit, _) = wm_runs
    for a, b in ((lt, lj), (lwt, lwj), (lit, lij)):
        np.testing.assert_allclose(a[:2], b[:2], rtol=1e-5)
        np.testing.assert_allclose(a, b, rtol=1e-3)


def test_wm_loop_trainable_matches_jax(wm_runs):
    (*_, jtr), (*_, tm) = wm_runs
    assert rel_l2(tm.trainable["msg_tables"].detach().numpy(),
                  np.asarray(jtr["msg_tables"])) <= 1e-2
    from nerf_signature_tpu_torch.models.hidden import decoder_leaves

    _, tm0 = make_wm_models("fp32")
    jleaves = jax.tree_util.tree_leaves(jtr["decoder"])
    tleaves = decoder_leaves(tm.trainable["decoder"])
    starts = decoder_leaves(tm0.trainable["decoder"])
    assert len(jleaves) == len(tleaves)
    lr = _wm_opt().lr
    for i, (a, b, a0) in enumerate(zip(tleaves, jleaves, starts)):
        a, a0, b = a.detach().numpy(), a0.numpy(), np.asarray(b)
        if b.ndim == 4:  # conv kernels: JAX HWIO, the port OIHW
            b = b.transpose(3, 2, 0, 1)
        if i % 4 == 2 and i < len(tleaves) - 2:  # a conv bias before a batch norm
            for x in (a, b):
                assert np.abs(x - a0).max() <= WM_STEPS * lr * (1 + 1e-3)
        else:
            assert rel_l2(a, b) <= 1e-2, i


# ---------------------------------------------------------------- host syncs
class HostSyncSpy(TorchDispatchMode):
    """Records the ops that read a value back to the host or copy one from
    it, and so cannot run inside a captured step: a scalar read (``item``,
    ``int()``, ``float()``, ``bool()``), ``nonzero`` and what implies it (a
    boolean index, ``masked_select``), a tensor made from host data."""

    SYNCS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
             "aten.lift_fresh", "aten.unique", "aten._unique", "aten.repeat_interleave")

    def __init__(self):
        super().__init__()
        self.found, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not self.paused:
            if name.startswith(self.SYNCS):
                self.found.append(name)
            if name.startswith(("aten.index.", "aten.index_put")):
                idx = args[1] if len(args) > 1 else []
                if any(t is not None and t.dtype == torch.bool for t in idx):
                    self.found.append(name + " (boolean index)")
        return func(*args, **(kwargs or {}))


def _paused(spy, fn, generator=False):
    """``fn`` with the spy paused while it runs."""
    def call(*a, **k):
        spy.paused = True
        try:
            return fn(*a, **k)
        finally:
            spy.paused = False

    def gen(*a, **k):
        it = fn(*a, **k)
        while True:
            spy.paused = True
            try:
                v = next(it)
            except StopIteration:
                return
            finally:
                spy.paused = False
            yield v

    return gen if generator else call


def _spy_card_path(trainer, spy, monkeypatch):
    """Pause the spy where the CPU runs what the card does not: Adam, whose
    CPU form reads its step count (the card runs it ``capturable``, with the
    lr set on the device as here), and the plain versions of the kernels
    (K1's corners, K2's slab test and march, K9's table sum), which make
    small constant tensors from host values."""
    from nerf_signature_tpu_torch.models import message as t_message
    from nerf_signature_tpu_torch.ops import hashenc as t_hashenc
    from nerf_signature_tpu_torch.ops import marching as t_march

    monkeypatch.setattr(trainer.optimizer, "step", _paused(spy, trainer.optimizer.step))
    monkeypatch.setattr(t_hashenc, "_corners", _paused(spy, t_hashenc._corners, True))
    for mod, name in ((t_march, "near_far_from_aabb"), (t_march, "_march_plain"),
                      (t_message, "msg_table_plain")):
        monkeypatch.setattr(mod, name, _paused(spy, getattr(mod, name)))
    sched = t_dl.DeviceSchedule(trainer.opt.lr, trainer.opt.iters, "cpu")
    lr = torch.zeros(())
    leaf = next(iter(trainer.optimizer.param_groups[0]["params"]))

    def device_lr(optimizer, first_leaf, schedule, device_schedule=None):
        st = optimizer.state.get(leaf)
        if st:
            lr.copy_(sched(st["step"]))

    monkeypatch.setattr(t_trainer, "set_lr", device_lr)
    monkeypatch.setattr(t_twm, "set_lr", device_lr)


@pytest.mark.parametrize("full", [True, False])
def test_clean_dispatch_reads_nothing_back(monkeypatch, full):
    """A clean dispatch (the grid update, full or partial, the compaction,
    the step) runs no op that reads a value back to the host, so its step
    can be captured and the update can run between replays."""
    _, tm = make_models("fp32", 1.0, budget=BUDGET)
    tm.rc = type(tm.rc)(**{**tm.rc.__dict__, "compact_frac": 0.5})
    tm.train_budget = BUDGET
    tt = t_trainer.Trainer("ngp", _clean_opt(), tm, workspace=None, use_checkpoint="scratch",
                           mute=True)
    poses, images, intr = _views(4)
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    tt.grid_updates = 0 if full else 16
    tm.occ.iter_density.fill_(tt.grid_updates)
    tm.occ.density.uniform_(-1.0, 10.0)
    spy = HostSyncSpy()
    _spy_card_path(tt, spy, monkeypatch)
    with spy:
        t_dl.device_train_loop(tt, data, 2)
    assert spy.found == [], spy.found
    assert tt.grid_updates == (1 if full else 17)


@pytest.mark.parametrize("distortion", ["jpeg", "blurring", "crop"])
def test_wm_dispatch_reads_nothing_back(monkeypatch, distortion):
    """A watermark dispatch (message, pixels, render, distortion, decoder,
    step) runs no op that reads a value back to the host."""
    _, tm = make_wm_models("fp32")
    tt = t_twm.WatermarkTrainer("wm", _wm_opt(distortion=distortion), tm, workspace=None,
                                use_checkpoint="scratch", mute=True)
    ro_b, rd_b, *_ = wm_batch(seed=3)
    poses, images, intr = _views(3, seed=5)
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    ro_b, rd_b = T(np.ascontiguousarray(ro_b)), T(np.ascontiguousarray(rd_b))
    t_dl.wm_device_loop(tt, data, ro_b, rd_b, 1)  # the one-time constants, made eagerly
    spy = HostSyncSpy()
    _spy_card_path(tt, spy, monkeypatch)
    with spy:
        t_dl.wm_device_loop(tt, data, ro_b, rd_b, 2)
    assert spy.found == [], spy.found


# ------------------------------------------------------------------------ grid
@pytest.mark.parametrize("full", [True, False])
def test_sync_free_grid_update_matches_the_previous_code(full):
    """The sync-free update (``torch.where`` on the weights, the losers of a
    repeated index written to a spare slot) in place, against the previous
    code (``bool(any())`` and boolean-mask indexing) on the grid tests'
    inputs."""
    def previous(grid, density_fn, draws):
        H = H_GRID
        tmp = -torch.ones_like(grid.density)
        dr = draws[0]
        rc = dr.rand_coords.to(torch.int64)
        rand_idx = (rc[:, 0] * H + rc[:, 1]) * H + rc[:, 2]
        occ_mask = (grid.density[0] > 0).to(torch.float32)
        weights = occ_mask if bool(occ_mask.any()) else torch.ones_like(occ_mask)
        cdf = torch.cumsum(weights, dim=0)
        occ_idx = torch.clamp(torch.searchsorted(cdf, dr.occ_u * cdf[-1]), 0, H**3 - 1)
        coords = torch.cat([rc, torch.stack([occ_idx // (H * H), (occ_idx // H) % H,
                                             occ_idx % H], -1)])
        idx = torch.cat([rand_idx, occ_idx])
        sig = density_fn(t_grid._cell_world_coords(coords, 1.0, H, dr.jitter))
        pos = torch.arange(idx.shape[0])
        last = torch.full((H**3,), -1, dtype=torch.int64)
        last.scatter_reduce_(0, idx, pos, reduce="amax")
        keep = last[idx] == pos
        tmp[0][idx[keep]] = sig[keep]
        return tmp

    _, tm = make_models("fp32", 1.0)
    gen = torch.Generator().manual_seed(0)
    tm.update_extra_state(draws=t_grid.draw_grid_randomness(gen, 1, H_GRID, True, "cpu"))
    draws = t_grid.draw_grid_randomness(gen, 1, H_GRID, full, "cpu")
    before = tm.occ._replace(**{k: v.clone() for k, v in tm.occ._asdict().items()})
    ids = [id(t) for t in tm.occ]
    tm.update_extra_state(draws=draws, full=full)
    assert [id(t) for t in tm.occ] == ids  # in place
    ref = t_grid.update_occupancy_grid(before, tm.density_fn, bound=1.0, grid_size=H_GRID,
                                       density_thresh=tm.density_thresh, full=full,
                                       draws=draws)
    for a, b in zip(tm.occ, ref):
        assert torch.equal(a, b)
    if not full:
        tmp = previous(before, tm.density_fn, draws)
        valid = (before.density >= 0) & (tmp >= 0)
        assert torch.equal(ref.density_live, torch.where(valid, tmp, before.density_live))
    empty = before._replace(density=torch.zeros_like(before.density))
    a = t_grid.update_occupancy_grid(empty, tm.density_fn, bound=1.0, grid_size=H_GRID,
                                     full=full, draws=draws)
    assert int(a.iter_density) == int(before.iter_density) + 1


# ------------------------------------------------------------------------ CLIs
def _clean_ckpt(tmp_path):
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
    from test_torch_render import ball_occupancy

    clean = NGPModel(NGPConfig(bound=1.0, n_levels=2, compute_dtype=torch.float32),
                     grid_size=16, device="cpu", seed=3)
    clean.params["hash_table"].mul_(1e4)
    clean.occ = clean.occ._replace(occupancy=T(ball_occupancy(1.0, H=16)))
    ckpt = str(tmp_path / "clean" / "ngp_ep0001.ckpt")
    t_ckpt.save_checkpoint(ckpt, {"params": clean.params, "occ": clean.occ})
    return ckpt


def _jax_reads(path):
    from nerf_signature_tpu.train import checkpoint as j_ckpt

    return j_ckpt.load_checkpoint(path)


def test_clean_cli_trains_with_steps_per_dispatch(tmp_path):
    """``main_nerf --cpu --steps_per_dispatch 4`` at a tiny config: two
    dispatches, then the evaluation; the checkpoint JAX loads holds the
    step count and Adam's count of 8."""
    import json

    from nerf_signature_tpu_torch import main_nerf as t_main
    from nerf_signature_tpu_torch.train.trainer import write_png
    from test_torch_wm_io import write_scene

    scene = write_scene(str(tmp_path / "scene"))
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        with open(os.path.join(scene, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        for fr in meta["frames"]:
            write_png(os.path.join(scene, fr["file_path"] + ".png"),
                      rng.integers(0, 255, (meta["h"], meta["w"], 3), dtype=np.uint8))
        if split == "test":
            with open(os.path.join(scene, "transforms_val.json"), "w") as f:
                json.dump(meta, f)
    ws = str(tmp_path / "ws")
    flags = [scene, "--workspace", ws, "--cpu", "-O", "--iters", "8", "--grid_size", "16",
             "--num_rays", "32", "--bound", "1.0", "--scale", "1.0", "--dt_gamma", "0",
             "--min_near", "0.05", "--density_thresh", "0.01", "--train_budget", "16",
             "--infer_budget", "16", "--max_steps", "64", "--n_levels", "2",
             "--steps_per_dispatch", "4"]
    assert t_main.main(flags) == 0
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert log.count("[device loop]") == 2 and "[eval]" in log
    ckpts = sorted(glob.glob(os.path.join(ws, "checkpoints", "ngp_ep*.ckpt")))
    raw = _jax_reads(ckpts[-1])
    assert int(raw["global_step"]) == 8
    assert int(np.asarray(raw["opt_state"]["0"]["count"])) == 8


def test_wm_cli_trains_with_steps_per_dispatch(tmp_path):
    """``main_nerf_wtmk --cpu --steps_per_dispatch 4``: 8 steps in two
    dispatches on the pseudo-GT pool; the watermark checkpoint JAX loads
    holds them."""
    from nerf_signature_tpu_torch import main_nerf_wtmk as t_main
    from test_torch_wm_io import _cli_flags, write_scene

    scene = write_scene(str(tmp_path / "scene"))
    ws = str(tmp_path / "ws")
    flags = _cli_flags(scene, ws, _clean_ckpt(tmp_path), iters=8) + [
        "--steps_per_dispatch", "4"]
    assert t_main.main(flags) == 0
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert log.count("[wm device loop]") == 2
    ckpts = sorted(glob.glob(os.path.join(ws, "checkpoints", "ngp_ep*.ckpt")))
    raw = _jax_reads(ckpts[-1])
    assert int(raw["global_step"]) == 8 and "trainable" in raw
    assert int(np.asarray(raw["opt_state"]["0"]["count"])) == 8
