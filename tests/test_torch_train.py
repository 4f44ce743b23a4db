"""Port parity of the clean train step: the loss of ``trainer.py:118-147``
and its gradients, one whole ``_train_step`` (Adam, EMA, lr schedule),
checkpoints resumed across the two packages, ``mark_untrained_grid`` and the
trainer's adaptation rules, each against the JAX package on the same inputs
(CPU: the plain versions of the kernels).

The random draws are JAX's: ``kbg, kperturb = jax.random.split(key)``, the
background ``uniform(kbg, (N, 3))`` and the march noise
``uniform(kperturb, (N,))`` (``marching.py:339``) are handed to the port as
tensors.  Errors are relative L2 per parameter leaf.

Tolerances and why:
  * on the same samples (the JAX march's samples handed to both): fp32 1e-5
    (measured <= 3.2e-7).  bf16 1e-3: the same bf16 rounding points in both
    packages give identical gradients on five leaves; on the sixth one entry
    of the once-rounded weight gradient lands on the neighbouring bf16 (its
    fp32 sum differs by an ulp), measured 1.9e-4.
  * end to end (each package marches): the masks are equal, but XLA on the
    CPU contracts ``t0 + i*dt`` and ``o + t*d`` into FMAs and the port does
    not (ROADMAP queue 3), so sample positions differ by an ulp.  At the
    finest level (resolution 128, table U(+-1)) that moves a feature by
    ~1e-5 relative and a corner weight likewise.  Measured: fp32 loss 7.5e-8
    relative, hash table 1.6e-4, first sigma layer 2.0e-4, the other leaves
    <= 4e-6; bound 1e-3 for those two leaves and 1e-4 for the rest.  In bf16
    the same ulps flip bf16 roundings: hash table 4.4e-2 (cosine 0.99902),
    first sigma layer 3.6e-2 (0.99936), the other leaves <= 1.5e-2 (>=
    0.9998); bound cosine 0.998 / 6e-2 for those two leaves and 0.999 /
    2e-2 for the rest.
  * after Adam's first step (eps 1e-15) each update is -lr * sign(g), so
    params are compared where |g| exceeds 1e-2 of the leaf's RMS gradient
    (a sign can only differ where |g| is within the gradient's error);
    gradients are compared everywhere.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu.ops import composite as j_comp
from nerf_signature_tpu.ops import grid as j_grid
from nerf_signature_tpu.ops import intersect as j_int
from nerf_signature_tpu.ops import marching as j_march
from nerf_signature_tpu.render import renderer as j_render
from nerf_signature_tpu.train import trainer as j_trainer
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import composite as t_comp
from nerf_signature_tpu_torch.ops import grid as t_grid
from nerf_signature_tpu_torch.ops import marching as t_march
from nerf_signature_tpu_torch.render import renderer as t_render
from nerf_signature_tpu_torch.train import trainer as t_trainer
from test_torch_render import H_GRID, make_models, view_rays
from test_torch_train_ops import one_torch_thread, rel_l2  # noqa: F401

T = torch.from_numpy
BUDGET = 32
LEAVES = ["hash_table", "sigma_net.0", "sigma_net.1", "color_net.0", "color_net.1",
          "color_net.2"]
# end-to-end bounds (see the module docstring): leaf -> (max rel L2, min cosine)
E2E = {"fp32": {"hash_table": (1e-3, None), "sigma_net.0": (1e-3, None)},
       "bf16": {"hash_table": (6e-2, 0.998), "sigma_net.0": (6e-2, 0.998)}}
E2E_REST = {"fp32": (1e-4, None), "bf16": (2e-2, 0.999)}


def leaves_j(tree):
    return [np.asarray(tree["hash_table"])] + [np.asarray(w) for w in tree["sigma_net"]] + [
        np.asarray(w) for w in tree["color_net"]]


def leaves_t(params, grad=False):
    return [(p.grad if grad else p).detach().numpy() for p in t_trainer.param_leaves(params)]


def cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def batch(seed=0, res=16):
    """A ball view's rays and RGBA pixels with partial alpha."""
    rays = view_rays(1.0, n=1, res=res, seed=seed)
    ro, rd = rays["rays_o"][0], rays["rays_d"][0]
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(ro.shape[0], 4)).astype(np.float32)
    return ro, rd, images


def draws(key, n):
    """JAX's draws of one train step, as the port takes them."""
    kbg, kperturb = jax.random.split(key)
    bg = np.asarray(jax.random.uniform(kbg, (n, 3)))
    noise = np.asarray(jax.random.uniform(kperturb, (n,)))
    return kperturb, bg, noise


def jax_loss_fn(jm, ro, rd, images, key):
    """The loss of trainer.py:118-147 (RGBA, random background)."""
    kperturb, bg, _ = draws(key, ro.shape[0])
    gt = images[..., :3] * images[..., 3:] + bg * (1.0 - images[..., 3:])

    def loss_fn(p):
        out = j_render.render_rays_occ(
            lambda x, d: j_ngp.ngp_field(p, jm.cfg, x, d), jm.occ.occupancy,
            jnp.asarray(ro), jnp.asarray(rd), jm.rc, budget=BUDGET, bg_color=jnp.asarray(bg),
            perturb_key=kperturb)
        return jnp.mean(jnp.mean((out["image"] - gt) ** 2, axis=-1))

    return loss_fn


def port_loss(tm, ro, rd, images, key):
    _, bg, noise = draws(key, ro.shape[0])
    for p in t_trainer.param_leaves(tm.params):
        p.requires_grad_(True)
    gt = images[..., :3] * images[..., 3:] + bg * (1.0 - images[..., 3:])
    fp = t_ngp.field_params(tm.params, tm.cfg)
    out = t_render.render_rays_occ(
        lambda x, d: t_ngp.ngp_field(fp, tm.cfg, x, d), tm.occ.occupancy, T(ro), T(rd),
        tm.rc, budget=BUDGET, bg_color=T(bg), noise=T(noise))
    return torch.mean(torch.mean((out["image"] - T(gt)) ** 2, dim=-1))


def _check_grads(gj, gt, dtype):
    for name, a, b in zip(LEAVES, gj, gt):
        max_rel, min_cos = E2E[dtype].get(name, E2E_REST[dtype])
        assert rel_l2(b, a) <= max_rel, (name, rel_l2(b, a))
        if min_cos is not None:
            assert cosine(a, b) >= min_cos, (name, cosine(a, b))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_loss_grads_match_jax_on_the_same_samples(dtype):
    """Field, compositor and loss differentiated on the JAX march's samples."""
    jm, tm = make_models(dtype, 1.0)
    ro, rd, images = batch()
    N = ro.shape[0]
    kperturb, bg, _ = draws(jax.random.PRNGKey(3), N)
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray([-1.0] * 3 + [1.0] * 3), jm.rc.min_near)
    m = j_march.march_rays(jnp.asarray(ro), jnp.asarray(rd), jm.occ.occupancy, nj, fj,
                           bound=1.0, max_steps=jm.rc.max_steps, budget=BUDGET,
                           grid_size=H_GRID, perturb_key=kperturb)
    xyz, dirs, deltas, ts, mask = (np.asarray(m[k]) for k in ("xyzs", "dirs", "deltas", "ts",
                                                               "mask"))
    gt = images[..., :3] * images[..., 3:] + bg * (1.0 - images[..., 3:])

    def loss_j(p):
        s, r = j_ngp.ngp_field(p, jm.cfg, jnp.asarray(xyz.reshape(-1, 3)),
                               jnp.asarray(dirs.reshape(-1, 3)))
        o = j_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), jnp.asarray(deltas),
                                  jnp.asarray(ts), mask=jnp.asarray(mask))
        img = o["image"] + (1.0 - o["weights_sum"])[:, None] * bg
        return jnp.mean(jnp.mean((img - gt) ** 2, axis=-1))

    lj, gj = jax.value_and_grad(loss_j)(jm.params)
    for p in t_trainer.param_leaves(tm.params):
        p.requires_grad_(True)
    fp = t_ngp.field_params(tm.params, tm.cfg)
    s, r = t_ngp.ngp_field(fp, tm.cfg, T(xyz.reshape(-1, 3)), T(dirs.reshape(-1, 3)))
    o = t_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), T(deltas), T(ts),
                              mask=T(mask))
    img = o["image"] + (1.0 - o["weights_sum"])[:, None] * T(bg)
    lt = torch.mean(torch.mean((img - T(gt)) ** 2, dim=-1))
    lt.backward()
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    bound = {"fp32": 1e-5, "bf16": 1e-3}[dtype]
    for name, a, b in zip(LEAVES, leaves_j(gj), leaves_t(tm.params, grad=True)):
        assert rel_l2(b, a) <= bound, (name, rel_l2(b, a))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_train_loss_grads_match_jax(dtype):
    """The train-step loss end to end: each package marches with the same
    noise and composites over the same random background."""
    jm, tm = make_models(dtype, 1.0)
    ro, rd, images = batch()
    key = jax.random.PRNGKey(5)
    kperturb, _, noise = draws(key, ro.shape[0])
    # equal march masks first (the FMA ulps must not move a sample)
    aabb = np.array([-1.0] * 3 + [1.0] * 3, np.float32)
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(aabb),
                                      jm.rc.min_near)
    mj = j_march.march_rays(jnp.asarray(ro), jnp.asarray(rd), jm.occ.occupancy, nj, fj,
                            bound=1.0, max_steps=jm.rc.max_steps, budget=BUDGET,
                            grid_size=H_GRID, perturb_key=kperturb)
    mt = t_march.march_rays_aabb(T(ro), T(rd), aabb, tm.occ.occupancy, min_near=tm.rc.min_near,
                                 bound=1.0, max_steps=tm.rc.max_steps, budget=BUDGET,
                                 noise=T(noise))
    assert np.array_equal(np.asarray(mj["mask"]), mt["mask"].numpy())
    assert mt["mask"].sum() > 100

    lj, gj = jax.value_and_grad(jax_loss_fn(jm, ro, rd, images, key))(jm.params)
    lt = port_loss(tm, ro, rd, images, key)
    lt.backward()
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    _check_grads(leaves_j(gj), leaves_t(tm.params, grad=True), dtype)


def _opt(**kw):
    d = dict(lr=1e-2, iters=100, max_ray_batch=128, devices=1, patch_size=1, num_rays=256,
             max_steps=128, compact_frac=-1, group_budget=-1, update_extra_interval=16)
    d.update(kw)
    return types.SimpleNamespace(**d)


def jax_step(jt, ro, rd, images, key):
    m = jt.model
    (m.params, jt.ema_params, jt.opt_state, loss, per_ray, n_occ, n_raw,
     n_groups) = j_trainer._train_step(
        m.params, jt.ema_params, jt.opt_state, m.occ.occupancy, jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(images), key, m.cfg, m.rc, BUDGET,
        jt.optimizer.update, True, jt.ema_decay)
    return loss, per_ray, n_occ, n_raw, n_groups


def port_step(tt, ro, rd, images, key):
    _, bg, noise = draws(key, ro.shape[0])
    return tt._train_step(T(ro), T(rd), T(images), T(bg), T(noise), tt.model.rc, BUDGET)


def test_lr_schedule_matches_jax():
    sj = j_trainer.make_lr_schedule(1e-2, 30000)
    st = t_trainer.make_lr_schedule(1e-2, 30000)
    for count in (0, 1, 15000, 30000, 40000):
        assert st(count) == pytest.approx(float(sj(jnp.int32(count))), rel=1e-6)
    assert st(0) == pytest.approx(1e-2) and st(30000) == pytest.approx(1e-3, rel=1e-6)


def test_train_step_matches_jax_train_step():
    jm, tm = make_models("fp32", 1.0)
    opt = _opt()
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    ro, rd, images = batch(seed=1)
    key = jax.random.PRNGKey(11)
    p0 = leaves_j(jm.params)
    _, gj = jax.value_and_grad(jax_loss_fn(jm, ro, rd, images, key))(jm.params)
    gj = leaves_j(gj)
    lj, prj, *cj = jax_step(jt, ro, rd, images, key)
    lt, prt, *ct = port_step(tt, ro, rd, images, key)

    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    np.testing.assert_allclose(prt.numpy(), np.asarray(prj), rtol=1e-4, atol=1e-7)
    for a, b in zip(cj, ct):
        assert np.array_equal(np.asarray(a), b.numpy())
    g_port = leaves_t(tm.params, grad=True)
    _check_grads(gj, g_port, "fp32")

    assert tt.opt_count() == 1 and int(jt.opt_state[0].count) == 1
    lr = t_trainer.make_lr_schedule(opt.lr, opt.iters)(0)
    for name, g, w0, pj, pt, ej, et in zip(LEAVES, gj, p0, leaves_j(jm.params),
                                           leaves_t(tm.params), leaves_j(jt.ema_params),
                                           leaves_t(tt.ema_params)):
        sure = np.abs(g) > 1e-2 * np.sqrt(np.mean(g**2))
        assert sure.mean() > 0.05, name
        np.testing.assert_allclose(pt[sure], pj[sure], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(pt[sure], (w0 - lr * np.sign(g))[sure], rtol=0, atol=1e-6)
        np.testing.assert_allclose(et[sure], ej[sure], rtol=0, atol=1e-6, err_msg=name)
        untouched = g == 0
        assert np.array_equal(pt[untouched], w0[untouched])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_resumes_across_packages(tmp_path, direction):
    """Two steps in one package, a full checkpoint, the third step in both
    (the reader resumes params, EMA and Adam's state): same loss and params."""
    jm, tm = make_models("fp32", 1.0)
    opt = _opt()
    ws = str(tmp_path)
    ro, rd, images = batch(seed=2)
    keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
    if direction == "port_to_jax":
        tt = t_trainer.Trainer("ngp", opt, tm, workspace=ws, use_checkpoint="scratch", mute=True)
        for k in keys[:2]:
            port_step(tt, ro, rd, images, k)
        tt.epoch = 1
        tt.save_checkpoint(full=True)
        jt = j_trainer.Trainer("ngp", opt, jm, workspace=ws, use_checkpoint="latest", mute=True)
        assert jt.epoch == 1 and int(jt.opt_state[0].count) == 2
        assert int(jt.opt_state[1].count) == 2
    else:
        jt = j_trainer.Trainer("ngp", opt, jm, workspace=ws, use_checkpoint="scratch", mute=True)
        for k in keys[:2]:
            jax_step(jt, ro, rd, images, k)
        jt.epoch = 1
        jt.save_checkpoint(full=True)
        tt = t_trainer.Trainer("ngp", opt, tm, workspace=ws, use_checkpoint="latest", mute=True)
        assert tt.epoch == 1 and tt.opt_count() == 2
    for a, b in zip(leaves_j(jm.params), leaves_t(tm.params)):
        assert np.array_equal(a, b)
    mu_j = leaves_j(jt.opt_state[0].mu)
    mu_t = [tt.optimizer.state[p]["exp_avg"].numpy() for p in t_trainer.param_leaves(tm.params)]
    for a, b in zip(mu_j, mu_t):
        assert np.array_equal(a, b)
    lj, *_ = jax_step(jt, ro, rd, images, keys[2])
    lt, *_ = port_step(tt, ro, rd, images, keys[2])
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    for name, a, b in zip(LEAVES, leaves_j(jm.params), leaves_t(tm.params)):
        assert rel_l2(b, a) <= 1e-5, (name, rel_l2(b, a))


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_mark_untrained_grid_matches_jax(bound):
    from nerf_signature_tpu_torch.data.rays import rand_poses

    poses = rand_poses(np.random.default_rng(4), 5, radius=2.5 * bound)
    intr = (80.0, 80.0, 8.0, 8.0)
    H = 16
    rng = np.random.default_rng(5)
    dens = rng.uniform(0, 5, size=(t_grid.num_cascades(bound), H**3)).astype(np.float32)
    gj = j_grid.init_occupancy_grid(bound, H)._replace(density=jnp.asarray(dens))
    gt = t_grid.init_occupancy_grid(bound, H)._replace(density=T(dens))
    oj = j_grid.mark_untrained_grid(gj, jnp.asarray(poses), intr, bound=bound, grid_size=H,
                                    chunk=2)
    ot = t_grid.mark_untrained_grid(gt, T(poses), intr, bound=bound, grid_size=H, chunk=2)
    dj, dt = np.asarray(oj.density), ot.density.numpy()
    assert np.array_equal(dj, dt)
    assert 0.01 < (dt == -1).mean() < 0.99


def test_adaptation_rules_match_jax():
    """_adapt_budget, _adapt_compaction, _adapt_group_budget and the t_cull
    gate of _rc_train on the same sequences of statistics."""
    jm, tm = make_models("fp32", 1.0)
    jm.train_budget = tm.train_budget = 64
    opt = _opt(max_steps=1024)
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    rng = np.random.default_rng(6)
    means = [150, 160, 170, 20, 18, 17, 16, 60, 61, 62, 5, 4, 3, 300, 310]
    seen = set()
    for it, mean in enumerate(means):
        if it == 5:  # the group budget adapts once the grid's full updates are done
            jm.occ = jm.occ._replace(iter_density=jnp.asarray(16, jnp.int32))
            tm.occ = tm.occ._replace(iter_density=torch.tensor(16, dtype=torch.int32))
        n_raw = rng.poisson(mean, size=256).astype(np.int32)
        n_occ = np.minimum(n_raw, jm.train_budget)
        groups = float(mean) / 3.0
        jt._adapt_budget(n_raw)
        jt._adapt_compaction(float(n_occ.mean()))
        jt._adapt_group_budget(groups)
        tt._adapt_budget(n_raw)
        tt._adapt_compaction(float(n_occ.mean()))
        tt._adapt_group_budget(groups)
        assert tm.train_budget == jm.train_budget, it
        assert tm.rc.compact_frac == jm.rc.compact_frac, it
        assert tm.rc.group_budget == jm.rc.group_budget, it
        seen.add((tm.train_budget, tm.rc.compact_frac, tm.rc.group_budget))
    # every rule moved, both ways
    for i in range(3):
        assert len({v[i] for v in seen}) >= 3, [v[i] for v in seen]
    import dataclasses
    for it_density in (3, 16):
        jm.occ = jm.occ._replace(iter_density=jnp.asarray(it_density, jnp.int32))
        tm.occ = tm.occ._replace(iter_density=torch.tensor(it_density, dtype=torch.int32))
        jm.rc = dataclasses.replace(jm.rc, t_cull=1e-5)
        tm.rc = dataclasses.replace(tm.rc, t_cull=1e-5)
        assert tt._rc_train().t_cull == jt._rc_train().t_cull
    assert tt._rc_train().t_cull == 1e-5


def test_trainer_refuses_unported_paths(monkeypatch):
    _, tm = make_models("fp32", 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_trainer.Trainer("ngp", _opt(devices=2), tm, workspace=None, mute=True)
    # LPIPS and CLIP are ported: a named weights file that does not exist,
    # and --clip_text without transformers (the import made to fail), raise
    # JAX's errors, not the port's refusal
    with pytest.raises(FileNotFoundError, match="does not exist"):
        t_trainer.Trainer("ngp", _opt(patch_size=4, lpips_weights="alex.pth"), tm,
                          workspace=None, mute=True)
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    with pytest.raises(RuntimeError, match="CLIP weights unavailable"):
        t_trainer.Trainer("ngp", _opt(clip_text="a chair"), tm, workspace=None, mute=True)
    # --hash_fwd_corners 1 is ported (K7) and, as in JAX, needs
    # --stochastic_hash_grad on the model's config
    with pytest.raises(ValueError, match="requires --stochastic_hash_grad"):
        t_trainer.Trainer("ngp", _opt(hash_fwd_corners=1), tm, workspace=None, mute=True)
    # the options the port runs construct (the error map and the SSIM patch
    # guard since they were ported)
    for kw in ({}, dict(error_map=True), dict(patch_size=4, lambda_ssim=0.1)):
        t_trainer.Trainer("ngp", _opt(**kw), tm, workspace=None, mute=True)


def test_training_with_t_cull_is_refused_at_the_start(tmp_path):
    """--t_cull > 0 is no longer refused at the start: the CLI takes the
    flag (and fails only on the missing scene), and the Trainer trains with
    it, exact (the bool grid) behind the fog gate and on the float render
    grid after it.  A march of the bool grid with t_cull > 0 is still
    refused."""
    import dataclasses

    from nerf_signature_tpu_torch import main_nerf as t_main
    from nerf_signature_tpu_torch.ops import marching as t_march

    with pytest.raises(Exception) as err:
        t_main.main([str(tmp_path / "no_scene"), "--cpu", "-O", "--t_cull", "1e-3"])
    assert "no transforms" in str(err.value) and "ROADMAP" not in str(err.value)
    _, tm = make_models("fp32", 1.0)
    tm.rc = dataclasses.replace(tm.rc, t_cull=1e-3)
    tt = t_trainer.Trainer("ngp", _opt(), tm, workspace=None, mute=True)
    ro, rd, images = batch()
    grids = []
    render_grid = t_trainer.render_grid

    def spy(occ, t_cull=0.0):
        grid = render_grid(occ, t_cull)
        grids.append(grid.dtype)
        return grid

    t_trainer.render_grid = spy
    try:
        for it_density in (3, 16):
            tm.occ.iter_density.fill_(it_density)
            loss = tt.train_step_data({"rays_o": ro, "rays_d": rd, "images": images})[0]
            assert np.isfinite(float(loss))
    finally:
        t_trainer.render_grid = render_grid
    assert grids == [torch.bool, torch.float32]
    assert tt.opt_count() == 2
    o, d = T(ro.reshape(-1, 3)), T(rd.reshape(-1, 3))
    with pytest.raises(ValueError, match="t_cull"):
        t_march.march_rays_aabb(o, d, (-1, -1, -1, 1, 1, 1), tm.occ.occupancy, min_near=0.2,
                                bound=1.0, t_cull=1e-3)


def test_trainer_train_runs_grid_maintenance_and_lowers_the_loss(tmp_path):
    """Trainer.train on a tiny ball scene: mark_untrained_grid, the grid
    update every 16 steps, the adaptations, the ring buffer."""
    from test_torch_serve import ball_loader

    _, tm = make_models("fp32", 1.0)
    tm.reset_extra_state()
    frames = ball_loader(n=4, res=16)

    class Loader(list):
        poses = None

    loader = Loader()
    rng = np.random.default_rng(0)
    for f in frames:
        idx = rng.permutation(256)[:128]
        loader.append({"rays_o": f["rays_o"][:, idx], "rays_d": f["rays_d"][:, idx],
                       "images": f["images"].reshape(1, -1, 4)[:, idx]})
    opt = _opt(iters=48, num_rays=128)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=str(tmp_path), use_checkpoint="scratch",
                           mute=True, max_keep_ckpt=2)
    tt.train(loader, None, max_epochs=12)
    assert tt.global_step == 48 and int(tm.occ.iter_density) == 3
    assert tt.stats["loss"][-1] < tt.stats["loss"][0]
    ckpts = sorted(os.listdir(tmp_path / "checkpoints"))
    assert ckpts == ["ngp_ep0011.ckpt", "ngp_ep0012.ckpt"]
