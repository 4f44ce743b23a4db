"""Port parity of the error map (``--error_map``) and the SSIM patch guard
(``--patch_size N --lambda_ssim w``): ``ssim_torch`` against JAX's
``ssim_jnp``; the error map's per-step EMA, ``sample_error_map`` on JAX's
uniforms, the map after a loop's steps and its last-wins scatter; clean and
watermark steps and loops with the SSIM term against JAX's on the same
draws; the combinations JAX refuses; the per-step precedence of patches
over the error map (pinned as JAX has it: a patch batch is never importance
sampled and never updates the map, while JAX's loop refuses the two
together -- ROADMAP queue 3).

Tolerances and why (fp32, the CPU):
  * SSIM: the value within 1e-6 and the gradient within 1e-5 relative
    (the same einsums, summed in another order).
  * the error map: ``sample_error_map`` exactly (the same uniforms; the
    CDF's cumsum is exact on the all-ones map); the map after the loop's
    steps within rtol 1e-5 (each cell's EMA of per-ray errors that differ
    by the loops' fp32 ulps).
  * steps and loops: as ``tests/test_torch_train.py`` and
    ``tests/test_torch_device_loop.py`` (losses 1e-5 relative; params 1e-4
    relative L2; the watermark loop's later steps 1e-3).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.data import rays as j_rays
from nerf_signature_tpu.train import device_loop as j_dl
from nerf_signature_tpu.train import metrics as j_metrics
from nerf_signature_tpu.train import trainer as j_trainer
from nerf_signature_tpu.train import trainer_wtmk as j_twm
from nerf_signature_tpu_torch.data import rays as t_rays
from nerf_signature_tpu_torch.train import device_loop as t_dl
from nerf_signature_tpu_torch.train import metrics as t_metrics
from nerf_signature_tpu_torch.train import trainer as t_trainer
from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
from test_torch_device_loop import (BUDGET, LEAVES, N_RAYS, N_STEPS, P, H, W, WM_RAYS, WM_STEPS,
                                    _clean_opt, _leaves_j, _leaves_t, _views, _wm_opt,
                                    jax_clean_draws)
from test_torch_render import make_models
from test_torch_train_ops import rel_l2
from test_torch_wm_train import make_wm_models, wm_batch

T = torch.from_numpy
EM = t_dl.EM_RES * t_dl.EM_RES


# ------------------------------------------------------------------- SSIM
@pytest.mark.parametrize("shape", [(8, 8), (4, 4), (5, 5), (11, 11), (16, 12), (3, 7)])
def test_ssim_matches_jax_value_and_gradient(shape):
    """Windows of 11 and the shrunken ones (the largest odd size that fits:
    3 for 4 x 4, 5, 11, 3 for 3 x 7)."""
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(size=(5, *shape, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1).astype(np.float32)
    vj, gj = jax.value_and_grad(lambda x: j_metrics.ssim_jnp(x, jnp.asarray(b)))(jnp.asarray(a))
    ta = T(a).requires_grad_()
    vt = t_metrics.ssim_torch(ta, T(b))
    vt.backward()
    assert abs(float(vt) - float(vj)) <= 1e-6
    gj = np.asarray(gj)
    assert np.abs(ta.grad.numpy() - gj).max() <= 1e-5 * np.abs(gj).max()
    assert float(t_metrics.ssim_torch(T(a), T(a))) == pytest.approx(1.0, abs=1e-6)


# -------------------------------------------------------------- error map
def test_sample_error_map_matches_jax_on_its_uniforms():
    """JAX's ``sample_error_map`` and the port's, given the uniforms JAX
    draws (``k1, k2, k3 = split(key, 3)``): an all-ones map (the CDF exact)
    and one that puts most of its mass on one cell."""
    Hi, Wi, N = 40, 56, 300
    key = jax.random.PRNGKey(5)
    k1, k2, k3 = jax.random.split(key, 3)
    u = np.stack([np.asarray(jax.random.uniform(k, (N,))) for k in (k1, k2, k3)])
    hot = np.full(EM, 1e-6, np.float32)
    hot[10 * 128 + 20] = 1.0
    for em in (np.ones(EM, np.float32), hot):
        pj, ij = j_dl.sample_error_map(key, jnp.asarray(em), N, Hi, Wi)
        pt, it = t_dl.sample_error_map(T(em), T(u), Hi, Wi)
        assert np.array_equal(np.asarray(ij), it.numpy())
        assert np.array_equal(np.asarray(pj), pt.numpy())
    assert (it == 10 * 128 + 20).float().mean() > 0.95


def test_error_map_scatter_resolves_duplicates_last_wins():
    """Repeated cells take their last sample's error, as a sequential
    scatter and as JAX's ``row.at[inds].set`` on the CPU."""
    rng = np.random.default_rng(3)
    em = rng.uniform(0.5, 1.5, size=(3, EM)).astype(np.float32)
    inds = rng.integers(0, 40, 200)  # many repeats
    err = rng.uniform(size=200).astype(np.float32)
    got = T(em.copy())
    t_dl.update_error_map_(got, torch.tensor([1]), T(inds), T(err))
    want = em.copy()
    for i, e in zip(inds, err):
        want[1, i] = np.float32(0.1) * em[1, i] + np.float32(0.9) * e
    assert np.array_equal(got.numpy(), want)
    row = jnp.asarray(em[1])
    jrow = row.at[jnp.asarray(inds)].set(0.1 * row[jnp.asarray(inds)] + 0.9 * jnp.asarray(err))
    assert np.array_equal(np.asarray(jrow), got[1].numpy())


class _Loader(list):
    poses = None


def _per_step_maps():
    """Both trainers' ``train_one_epoch`` over importance-sampled batches
    (inds_coarse with repeats) and a patch batch (none), each step's per-ray
    errors fixed: the error maps after the epoch."""
    rng = np.random.default_rng(2)
    batches = []
    for i in range(4):
        inds = rng.integers(0, 300, 64)
        b = {"rays_o": np.zeros((1, 64, 3), np.float32), "images": np.zeros((1, 64, 4)),
             "index": i % 2, "inds_coarse": inds[None],
             "err": rng.uniform(size=64).astype(np.float32)}
        batches.append(b)
    batches.append({"rays_o": np.zeros((1, 64, 3), np.float32), "images": np.zeros((1, 64, 4)),
                    "err": rng.uniform(size=64).astype(np.float32)})  # a patch batch
    em0 = rng.uniform(0.5, 2.0, size=(2, EM)).astype(np.float32)
    jm, tm = make_models("fp32", 1.0)
    maps = []
    for pkg, m, conv in ((j_trainer, jm, jnp.asarray), (t_trainer, tm, T)):
        tr = pkg.Trainer("ngp", _clean_opt(iters=100), m, workspace=None,
                         use_checkpoint="scratch", mute=True)
        loader = _Loader(batches)
        loader.error_map = em0.copy()
        z = conv(np.zeros(64, np.int32))
        loss = conv(np.array(0.1, np.float32))
        tr.train_step_data = lambda d, conv=conv, z=z, loss=loss: (loss, conv(d["err"]), z, z, z)
        tr.train_one_epoch(loader)
        maps.append(loader.error_map)
    return em0, batches, maps


def test_per_step_error_map_update_matches_jax():
    em0, batches, (mj, mt) = _per_step_maps()
    assert np.array_equal(mt, mj)
    touched = np.zeros_like(em0, bool)
    for b in batches[:4]:
        touched[b["index"], b["inds_coarse"][0]] = True
    assert not np.array_equal(mt[touched], em0[touched])
    assert np.array_equal(mt[~touched], em0[~touched])  # the patch batch updated nothing


def test_patches_win_over_the_error_map_per_step():
    """Pinned as JAX has it (``data/rays.py:78-110``): with both, the
    sampler draws patches, ignores the map and returns no inds_coarse, so
    the per-step EMA never runs on such a batch (the test above); the CLI's
    ``apply_O_macro`` turns --error_map off under --patch_size in both."""
    from nerf_signature_tpu.utils.config import apply_O_macro as j_macro
    from nerf_signature_tpu_torch.utils.config import apply_O_macro as t_macro

    poses = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
    em = np.random.default_rng(0).uniform(size=(1, EM)).astype(np.float32)
    out = []
    for mod in (j_rays, t_rays):
        out.append(mod.get_rays(poses, (20.0, 20.0, 16.0, 16.0), 32, 32, 64,
                                rng=np.random.default_rng(4), error_map=em, patch_size=4))
    for r in out:
        assert "inds_coarse" not in r
        pix = r["inds"].reshape(4, 4, 4)  # 4 patches of 4 x 4, rows of 32
        assert np.array_equal(pix[:, :, 1:] - pix[:, :, :-1], np.ones((4, 4, 3)))
    assert np.array_equal(np.asarray(out[0]["inds"]), out[1]["inds"])
    for macro in (j_macro, t_macro):
        opt = types.SimpleNamespace(O=False, patch_size=4, error_map=True, num_rays=64)
        assert macro(opt).error_map is False


@pytest.fixture(scope="module")
def em_loop_runs():
    """JAX's clean loop with ``error_map`` and the port's on JAX's draws
    (the map's uniforms from each step's ``ki``)."""
    jm, tm = make_models("fp32", 1.0, budget=BUDGET)
    for m in (jm, tm):
        m.rc = type(m.rc)(**{**m.rc.__dict__, "compact_frac": 0.5})
        m.train_budget = BUDGET
        m.density_thresh = 5.0
    opt = _clean_opt()
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    poses, images, intr = _views(4, seed=1)
    key = jax.random.PRNGKey(23)
    em0 = np.ones((P, EM), np.float32)
    out = j_dl.device_train_loop(
        jm.params, jt.ema_params, jt.opt_state, jm.occ, jnp.asarray(poses),
        jnp.asarray(images.reshape(P, -1, 4)), jnp.asarray(intr), key, 0, jt.cfg_train,
        jt._rc_train(), BUDGET, jt.optimizer.update, True, jt.ema_decay, N_STEPS, N_RAYS, H, W,
        update_interval=16, density_thresh=jm.density_thresh, grid_full_until=16,
        error_map=jnp.asarray(em0))
    draws, grid = jax_clean_draws(key, N_STEPS, tm.occ.density.shape[0], {0: True, 16: True})
    em_u = []
    for k in jax.random.split(key, N_STEPS):
        ki = jax.random.split(k, 5)[2]
        em_u.append([np.asarray(jax.random.uniform(kk, (N_RAYS,))) for kk in
                     jax.random.split(ki, 3)])
    draws = draws._replace(pix=None, em_u=T(np.asarray(em_u, np.float32)))
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    em = T(em0.copy())
    stats = t_dl.device_train_loop(tt, data, N_STEPS, draws=draws,
                                   grid_draws=lambda step, full: grid[step], error_map=em)
    return out, em0, stats, em


def test_error_map_loop_matches_jax(em_loop_runs):
    out, em0, stats, em = em_loop_runs
    np.testing.assert_allclose(stats.losses, np.asarray(out[4]), rtol=1e-5)
    mj = np.asarray(out[6])
    np.testing.assert_allclose(em.numpy(), mj, rtol=1e-5)
    assert not np.array_equal(mj, em0)
    changed = (em.numpy() != em0).sum()
    assert 0 < changed <= N_STEPS * N_RAYS


# ------------------------------------------------------------ the SSIM term
def test_clean_step_with_the_ssim_term_matches_jax():
    from test_torch_train import batch, draws, leaves_j, leaves_t

    jm, tm = make_models("fp32", 1.0)
    opt = _clean_opt(num_rays=256, patch_size=4, lambda_ssim=0.1)
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    ro, rd, images = batch(seed=3)
    key = jax.random.PRNGKey(29)

    (pj, _, _, lj, prj, *cj) = j_trainer._train_step(
        jm.params, jt.ema_params, jt.opt_state, jm.occ.occupancy, jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(images), key, jm.cfg, jm.rc, 32, jt.optimizer.update, True,
        jt.ema_decay, None, 4, lambda_ssim=jnp.float32(0.1))
    _, bg, noise = draws(key, ro.shape[0])
    lt, prt, *ct = tt._train_step(T(ro), T(rd), T(images), T(bg), T(noise), tm.rc, 32)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    np.testing.assert_allclose(prt.numpy(), np.asarray(prj), rtol=1e-4, atol=1e-7)
    # the SSIM term is in: the loss is above the plain MSE
    assert float(lt) > float(prt.mean()) + 1e-3
    for name, a, b in zip(LEAVES, leaves_j(pj), leaves_t(tm.params)):
        assert rel_l2(b, a) <= 1e-4, (name, rel_l2(b, a))


def test_wm_step_with_the_ssim_term_matches_jax(monkeypatch):
    from test_torch_wm_train import (BUDGET as WB, LAMBDA_I, LAMBDA_W, check_grads,
                                     jax_march_into_port)

    jax_march_into_port(monkeypatch)
    jm, tm = make_wm_models("fp32")
    ro_b, rd_b, ct_o, ct_d, gt = wm_batch(seed=2)
    message = np.array([1, 0, 0], np.int32)

    def loss_fn(tr):
        return j_twm._wm_step_loss(
            jm.backbone, tr, jm.occ.occupancy, *(jnp.asarray(v) for v in
                                                 (ro_b, rd_b, ct_o, ct_d, gt)),
            jnp.asarray(message), jax.random.PRNGKey(0), LAMBDA_W, LAMBDA_I, jm.wcfg, jm.rc, WB,
            WB, "none", j_twm.make_loss_w("bce"), patch_size=4, lambda_ssim=jnp.float32(0.2))

    (lj, _), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jm.trainable)
    leaves = t_twm.trainable_leaves(tm.trainable)
    for p in leaves:
        p.requires_grad_(True)
    lt, (_, lit, _) = t_twm._wm_step_loss(
        tm.backbone, tm.trainable, tm.occ.occupancy,
        *(T(np.ascontiguousarray(v)) for v in (ro_b, rd_b, ct_o, ct_d, gt)),
        torch.as_tensor(message), None, LAMBDA_W, LAMBDA_I, tm.wcfg, tm.rc, WB, WB, "none",
        t_twm.make_loss_w("bce"), patch_size=4, lambda_ssim=0.2)
    lt.backward()
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    check_grads(gj, t_twm._tree_map(lambda t: t.grad, tm.trainable), 1e-5, 1e-4)


def _jax_patch_pix(ki, n, pp):
    """JAX's patch-structured pixels of one step from its ``ki``."""
    npatch = n // (pp * pp)
    kx, ky, kt = jax.random.split(ki, 3)
    tx = np.asarray(jax.random.randint(kx, (npatch,), 0, H - pp))
    ty = np.asarray(jax.random.randint(ky, (npatch,), 0, W - pp))
    rest = np.asarray(jax.random.randint(kt, (n - npatch * pp * pp,), 0, H * W))
    return t_dl.patch_grid(T(tx)[None], T(ty)[None], pp, W, T(rest)[None])[0].numpy()


def test_clean_loop_with_the_ssim_term_matches_jax():
    """18 clean loop steps with 3 x 3 patches (7 of them and one uniform
    ray of 64) and the SSIM term, on JAX's draws."""
    pp = 3
    jm, tm = make_models("fp32", 1.0, budget=BUDGET)
    for m in (jm, tm):
        m.rc = type(m.rc)(**{**m.rc.__dict__, "compact_frac": 0.5})
        m.train_budget = BUDGET
        m.density_thresh = 5.0
    opt = _clean_opt(patch_size=pp, lambda_ssim=0.1)
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    poses, images, intr = _views(4, seed=3)
    key = jax.random.PRNGKey(31)
    out = j_dl.device_train_loop(
        jm.params, jt.ema_params, jt.opt_state, jm.occ, jnp.asarray(poses),
        jnp.asarray(images.reshape(P, -1, 4)), jnp.asarray(intr), key, 0, jt.cfg_train,
        jt._rc_train(), BUDGET, jt.optimizer.update, True, jt.ema_decay, N_STEPS, N_RAYS, H, W,
        update_interval=16, density_thresh=jm.density_thresh, grid_full_until=16,
        patch_size=pp, lambda_ssim=jnp.float32(0.1))
    draws, grid = jax_clean_draws(key, N_STEPS, tm.occ.density.shape[0], {0: True, 16: True})
    pix = [_jax_patch_pix(jax.random.split(k, 5)[2], N_RAYS, pp)
           for k in jax.random.split(key, N_STEPS)]
    draws = draws._replace(pix=T(np.stack(pix).astype(np.int64)))
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    stats = t_dl.device_train_loop(tt, data, N_STEPS, draws=draws,
                                   grid_draws=lambda step, full: grid[step])
    np.testing.assert_allclose(stats.losses, np.asarray(out[4]), rtol=1e-5)
    for name, pj, pt in zip(LEAVES, _leaves_j(out[0]), _leaves_t(tm.params)):
        assert rel_l2(pt, pj) <= 1e-4, name
    # the port's own draws are patch-structured too
    d = t_dl.draw_clean(torch.Generator().manual_seed(0), 2, P, N_RAYS, H * W, True, "cpu",
                        patch=(pp, H, W))
    rows = d.pix[:, :63].reshape(2, 7, pp, pp)
    assert torch.equal(rows[..., 1:] - rows[..., :-1], torch.ones((2, 7, pp, pp - 1),
                                                                   dtype=torch.int64))


def test_wm_loop_with_the_ssim_term_matches_jax():
    """4 watermark loop steps with 3 x 3 content patches (3 of them and 5
    uniform rays of 32) and the SSIM term, on JAX's draws."""
    pp = 3
    jm, tm = make_wm_models("fp32")
    opt = _wm_opt(patch_size=pp, lambda_ssim=0.2)
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    ro_b, rd_b, *_ = wm_batch(seed=3)
    poses, images, intr = _views(3, seed=5)
    key = jax.random.PRNGKey(37)
    D = tm.wcfg.message_dim
    (_, _, lj, lwj, lij) = j_twm._wm_device_loop(
        jm.backbone, jm.trainable, jt.opt_state, jm.occ.occupancy, jnp.asarray(ro_b),
        jnp.asarray(rd_b), jnp.asarray(poses), jnp.asarray(images.reshape(P, -1, 3)),
        jnp.asarray(intr), key, jnp.float32(opt.lambda_w), jnp.float32(opt.lambda_i),
        jt.wcfg_train, jm.rc, jt.content_budget, jm.infer_budget, jt.optimizer.update,
        "noise", "bce", WM_STEPS, WM_RAYS, H, W, patch_size=pp, lambda_ssim=jnp.float32(0.2))
    msg, pidx, pix, dist = [], [], [], []
    shape = t_twm.view_batch_shape(ro_b.shape)
    for k in jax.random.split(key, WM_STEPS):
        km, kp, ki, kd = jax.random.split(k, 4)
        msg.append(np.asarray(jax.random.randint(km, (D,), 0, 2)))
        pidx.append(int(jax.random.randint(kp, (), 0, P)))
        pix.append(_jax_patch_pix(ki, WM_RAYS, pp))
        dist.append(np.asarray(jax.random.normal(kd, shape)))
    draws = t_dl.WmDraws(T(np.stack(msg).astype(np.int32)), torch.tensor(pidx),
                         T(np.stack(pix).astype(np.int64)), T(np.stack(dist)))
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    lt, lwt, lit = t_dl.wm_device_loop(tt, data, T(np.ascontiguousarray(ro_b)),
                                       T(np.ascontiguousarray(rd_b)), WM_STEPS, draws=draws)
    for a, b in ((lt, np.asarray(lj)), (lwt, np.asarray(lwj)), (lit, np.asarray(lij))):
        np.testing.assert_allclose(a[:2], b[:2], rtol=1e-5)
        np.testing.assert_allclose(a, b, rtol=1e-3)


# -------------------------------------------------------------- refusals
def test_the_combinations_jax_refuses_are_refused():
    jm, tm = make_models("fp32", 1.0)
    # --lambda_ssim without patches, both stages: JAX's ValueError
    for pkg, m in ((j_trainer, jm), (t_trainer, tm)):
        with pytest.raises(ValueError, match="--lambda_ssim needs --patch_size > 1"):
            pkg.Trainer("ngp", _clean_opt(lambda_ssim=0.1), m, workspace=None, mute=True)
    jw, tw = make_wm_models("fp32")
    for pkg, m in ((j_twm, jw), (t_twm, tw)):
        with pytest.raises(ValueError, match="patch-structured content rays"):
            pkg.WatermarkTrainer("wm", _wm_opt(lambda_ssim=0.1), m, workspace=None, mute=True)
    # the loop refuses the SSIM patch sampling with the error map (JAX's message)
    loader = types.SimpleNamespace(error_map=np.ones((P, EM), np.float32))
    for pkg, m in ((j_trainer, jm), (t_trainer, tm)):
        tr = pkg.Trainer("ngp", _clean_opt(patch_size=4, lambda_ssim=0.1), m, workspace=None,
                         mute=True)
        with pytest.raises(RuntimeError, match="mutually exclusive in the scan loop"):
            tr.train_device(loader, 4, steps_per_dispatch=4)
    # LPIPS weights and CLIP text stay refused (their weights are not in the repo)
    for kw in (dict(patch_size=4, lpips_weights="alex.pth"), dict(clip_text="a chair")):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1: LPIPS and CLIP weights"):
            t_trainer.Trainer("ngp", _clean_opt(**kw), tm, workspace=None, mute=True)


# ------------------------------------------------------------------- CLIs
def test_clis_train_with_the_cull_the_error_map_and_the_ssim_guard(tmp_path):
    """``main_nerf --cpu`` with ``--t_cull 1e-5 --error_map`` per step and
    with ``--patch_size 2 --lambda_ssim 0.1 --t_cull 1e-5`` through the
    loop; ``main_nerf_wtmk --cpu`` with the cull and the SSIM guard."""
    import glob

    from nerf_signature_tpu_torch import main_nerf as t_main
    from nerf_signature_tpu_torch import main_nerf_wtmk as t_main_wm
    from test_torch_device_loop import _clean_ckpt, _jax_reads
    from test_torch_wm_io import _cli_flags, write_scene

    scene = write_scene(str(tmp_path / "scene"))
    import json

    from nerf_signature_tpu_torch.train.trainer import write_png

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
    base = [scene, "--cpu", "-O", "--iters", "4", "--grid_size", "16", "--num_rays", "32",
            "--bound", "1.0", "--scale", "1.0", "--dt_gamma", "0", "--min_near", "0.05",
            "--density_thresh", "0.01", "--train_budget", "16", "--infer_budget", "16",
            "--max_steps", "64", "--n_levels", "2", "--t_cull", "1e-5"]
    for name, extra in (("em", ["--error_map"]),
                        ("ssim", ["--patch_size", "2", "--lambda_ssim", "0.1",
                                  "--steps_per_dispatch", "2"])):
        ws = str(tmp_path / name)
        assert t_main.main(base + ["--workspace", ws] + extra) == 0
        log = open(os.path.join(ws, "log_ngp.txt")).read()
        assert "[eval]" in log
        if name == "ssim":
            assert "[ssim] patch SSIM guard active" in log
    ws = str(tmp_path / "wm")
    flags = _cli_flags(scene, ws, _clean_ckpt(tmp_path), iters=4) + [
        "--t_cull", "1e-5", "--patch_size", "2", "--lambda_ssim", "0.1", "--num_rays", "32"]
    assert t_main_wm.main(flags) == 0
    ckpts = sorted(glob.glob(os.path.join(ws, "checkpoints", "ngp_ep*.ckpt")))
    assert int(_jax_reads(ckpts[-1])["global_step"]) == 4
