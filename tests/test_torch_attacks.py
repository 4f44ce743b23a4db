"""Port parity of the attack suites against the JAX package on the same
inputs (CPU: the plain versions of the kernels): the 13 entries of the
attack registry with JAX's draws handed over, ``round_pixel``'s
straight-through gradient, ``project_linf`` and ``psnr``; the sweep's block
renders and decoded logits, and the sweep end to end; the parameter attack's
and the finetuning attack's losses and gradients (the JAX side is its own
attack step, run eagerly as the other parity tests run JAX, its optimizer
swapped for one that hands back the gradients: under ``jax.jit`` XLA may
keep excess precision across a bf16 rounding, which moved the message
tables' bf16 gradient by 3-5e-3 against 2e-4 eagerly); one Adam-and-clamp step against optax; the finetuning attack's
"only the hash table changes" and its empty-loader error; the parameter
attack's epsilon ball.

Tiny sizes, the models and rays of test_torch_wm_train (3 key blocks of 4x4
rays, 64 content rays, a ball grid of 16^3 cells, budget 16); "on the same
samples" as there (the port marches with JAX's ``march_rays``).

Tolerances and why:
  * attacks: atol 1e-5 (the distortions' bound: grid_sample's sample
    positions, the resize's fp32 weights, the JPEG model's transforms; a
    rounding flip of the JPEG quantiser would move a block by a step:
    test_torch_jpeg bounds those, these inputs have none);
  * decoded logits: rtol 1e-4, atol 1e-5 (test_torch_wm_train's bound: conv
    sums in another order through 9 batch norms);
  * losses and gradients on the same samples, as the watermark step's
    (test_torch_wm_train): loss 1e-6 (fp32) / 1e-5 (bf16) relative; the
    message tables 1e-5 / 1e-3 relative L2; the backbone table and MLP
    weights of the finetuning attack 1e-5 / 2e-2 (fp32: the same sums; bf16:
    test_torch_train's bound for the clean step's weight gradients, the same
    bf16 roundings of activations and cotangents in another order);
  * Adam and the clamp: atol 1e-7 (a few ulps of weights of ~0.1, 7.5e-9
    an ulp: the bias corrections divide in another order; measured 3e-8).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_signature_tpu.models import watermark as j_wm
from nerf_signature_tpu.render import renderer as j_render
from nerf_signature_tpu.train import attack as j_atk
from nerf_signature_tpu.train import trainer_wtmk as j_twm
from nerf_signature_tpu.utils import attacks as j_attacks
from nerf_signature_tpu_torch.train import attack as t_atk
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
from nerf_signature_tpu_torch.utils import attacks as t_attacks
from test_torch_wm_ops import rel_l2, wm_cfgs, wm_params
from test_torch_wm_train import BUDGET, _opt, jax_march_into_port, make_wm_models, wm_batch

T = torch.from_numpy
NAMES = list(j_attacks.ATTACKS)


def jax_attack_draws(name, key, shape):
    """The random inputs JAX's registry entry draws from ``key``."""
    if name == "noise_01":
        return jax.random.normal(key, shape)
    if name == "rotation_15":
        return jax.random.uniform(key, (shape[0],), minval=-15.0, maxval=15.0)
    if name == "scaling":
        return jax.random.uniform(key, (), minval=0.75, maxval=1.25)
    return None


def _t(draws):
    return None if draws is None else T(np.asarray(draws))


def test_registry_names_and_order_match_jax():
    assert list(t_attacks.ATTACKS) == NAMES and len(NAMES) == 13


@pytest.mark.parametrize("name", NAMES)
def test_attack_matches_jax(name):
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(4, 12, 10, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    yj = np.asarray(j_attacks.ATTACKS[name](key, jnp.asarray(img)))
    draws = jax_attack_draws(name, key, img.shape)
    yt = t_attacks.ATTACKS[name](T(img), _t(draws)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5)
    own = t_attacks.attack_draws(name, img.shape, torch.Generator().manual_seed(0), "cpu")
    assert (own is None) == (draws is None)
    if own is not None:  # the draws the port makes itself have JAX's shapes
        assert tuple(own.shape) == tuple(np.asarray(draws).shape)


def test_resize_downsamples_with_antialiasing_like_jax():
    img = np.random.default_rng(2).uniform(size=(2, 12, 12, 3)).astype(np.float32)
    for factor in (0.5, 0.45):
        yj = np.asarray(j_attacks.resize_attack(jnp.asarray(img), factor))
        np.testing.assert_allclose(t_attacks.resize_attack(T(img), factor).numpy(), yj,
                                   rtol=0, atol=1e-5)


def test_pixel_ops_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.1, 1.1, size=(2, 6, 6, 3)).astype(np.float32)
    y = rng.uniform(size=x.shape).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    yj, vjp = jax.vjp(j_attacks.round_pixel, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(ct))
    xt = T(x).requires_grad_(True)
    yt = t_attacks.round_pixel(xt)
    yt.backward(T(ct))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=0, atol=1e-6)
    assert np.array_equal(xt.grad.numpy(), ct) and np.array_equal(np.asarray(gj), ct)
    assert np.array_equal(t_attacks.clamp_pixel(T(x)).numpy(),
                          np.asarray(j_attacks.clamp_pixel(jnp.asarray(x))))
    for radius in (1.0, 8.0):
        np.testing.assert_allclose(
            t_attacks.project_linf(T(x), T(y), radius).numpy(),
            np.asarray(j_attacks.project_linf(jnp.asarray(x), jnp.asarray(y), radius)),
            rtol=0, atol=1e-7)
    assert float(t_attacks.psnr(T(x), T(y))) == pytest.approx(
        float(j_attacks.psnr(jnp.asarray(x), jnp.asarray(y))), rel=1e-6)
    assert float(t_attacks.psnr(T(y), T(y))) == pytest.approx(120.0)


def _trainers(dtype="fp32", **kw):
    jm, tm = make_wm_models(dtype)
    opt = _opt(**kw)
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    return jm, tm, jt, tt


def test_sweep_block_renders_match_jax(monkeypatch):
    jax_march_into_port(monkeypatch)
    jm, tm, jt, tt = _trainers()
    ro_b, rd_b, *_ = wm_batch()
    messages = np.array([[1, 0, 1], [0, 1, 1]], np.int32)
    bj = np.asarray(j_atk._attack_render_batch(
        jm.backbone, jm.trainable, jm.occ.occupancy, jnp.asarray(ro_b), jnp.asarray(rd_b),
        jnp.asarray(messages), jm.wcfg, dataclasses.replace(jm.rc, compact_frac=0.0,
                                                            prefilter=False, t_cull=0.0),
        jm.infer_budget))
    for msg, b in zip(messages, bj):
        fp = t_twm.wtmk_field_params(tm.backbone, tm.trainable, tm.wcfg, torch.as_tensor(msg))
        with torch.no_grad():
            bt = t_twm._render_blocks(fp, tm.occ.occupancy, T(ro_b), T(rd_b), tm.wcfg,
                                      tt._rc_eval(), tm.infer_budget)
        np.testing.assert_allclose(bt.numpy(), b, rtol=0, atol=1e-5)


def test_sweep_decoded_logits_match_jax():
    """Every attack on the same two-view blocks with the same draws: attack
    and normalisation per view, then the decoder (batch statistics over one
    message's blocks).  One view is the sweep end to end, below."""
    n_views = 2
    jcfg, _ = wm_cfgs()
    jcfg = dataclasses.replace(jcfg, n_views=n_views)
    p = wm_params(jcfg)
    dec_j = jax.tree_util.tree_map(jnp.asarray, p["trainable"]["decoder"])
    dec_t = t_ckpt.trainable_from_jax(p["trainable"])["decoder"]
    rng = np.random.default_rng(4)
    blocks = rng.uniform(size=(3, 8, 8, 3 * n_views)).astype(np.float32)
    shape = (3 * n_views, 8, 8, 3)
    for i, name in enumerate(NAMES):
        key = jax.random.PRNGKey(i)
        dj = np.asarray(j_atk._attack_decode_batch(dec_j, jnp.asarray(blocks)[None], key[None],
                                                   jcfg, name))[0]
        with torch.no_grad():
            dt = t_atk.attack_decode(dec_t, jcfg, T(blocks), name,
                                     _t(jax_attack_draws(name, key, shape)))
        np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-4, atol=1e-5, err_msg=name)


def test_attack_sweep_matches_jax_end_to_end(monkeypatch):
    """The same messages (the trainers' seeded streams), blocks and
    decodes: the same bit accuracy for each deterministic attack."""
    jax_march_into_port(monkeypatch)
    jm, tm, jt, tt = _trainers(bitacc_batch=4)
    ro_b, rd_b, *_ = wm_batch()
    loader = [{"watermark": {"rays_o_block": ro_b, "rays_d_block": rd_b}}]
    names = ["none", "blur", "crop_50", "round"]
    rj = j_atk.attack_sweep(jt, loader, attacks=names, n_test=6)
    rt = t_atk.attack_sweep(tt, loader, attacks=names, n_test=6)
    assert list(rt) == names and rt == rj
    assert jt.rng.integers(0, 2**31) == tt.rng.integers(0, 2**31)  # as many draws


def _grads_as_state(grads, state, params):
    """An optax-style update that moves nothing and returns the gradients
    as the new optimizer state (how the tests read JAX's attack steps')."""
    return jax.tree_util.tree_map(jnp.zeros_like, grads), grads


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_parameter_attack_loss_and_grads_match_jax(monkeypatch, dtype):
    jax_march_into_port(monkeypatch)
    jm, tm, jt, tt = _trainers(dtype)
    _, _, ct_o, ct_d, gt = wm_batch(seed=3)
    message = np.array([0, 1, 1], np.int32)
    rc_j = dataclasses.replace(jm.rc, t_cull=0.0)
    _, gj, lj = j_atk._param_attack_step.__wrapped__(
        jm.trainable, None, jnp.asarray(message), jm.backbone, jm.occ.occupancy, jm.trainable,
        jnp.asarray(ct_o), jnp.asarray(ct_d), jnp.asarray(gt), jnp.float32(1e-3), jm.wcfg, rc_j,
        BUDGET, _grads_as_state)
    leaves = t_twm.trainable_leaves(tm.trainable)
    lt = t_atk.param_attack_loss(tm.backbone, tm.trainable, tm.occ.occupancy, T(ct_o), T(ct_d),
                                 T(gt), torch.as_tensor(message), tm.wcfg,
                                 dataclasses.replace(tm.rc, t_cull=0.0), BUDGET)
    gt_ = torch.autograd.grad(lt, leaves, allow_unused=True)
    lim, msg_lim = {"fp32": (1e-6, 1e-5), "bf16": (1e-5, 1e-3)}[dtype]
    assert abs(float(lt) - float(lj)) <= lim * abs(float(lj))
    assert rel_l2(gt_[0].numpy(), np.asarray(gj["msg_tables"])) <= msg_lim
    # the loss never reaches the decoder: JAX's gradients are zeros, the port's absent
    assert all(g is None for g in gt_[1:])
    assert not any(np.asarray(g).any() for g in jax.tree_util.tree_leaves(gj["decoder"]))


@pytest.mark.parametrize("full", [False, True], ids=["hash_table", "full_backbone"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_finetune_attack_loss_and_grads_match_jax(monkeypatch, dtype, full):
    jax_march_into_port(monkeypatch)
    jm, tm, jt, tt = _trainers(dtype)
    _, _, ct_o, ct_d, gt = wm_batch(seed=4)
    keys = list(jm.backbone) if full else ["hash_table"]
    _, gj, lj = j_atk._finetune_attack_step.__wrapped__(
        {k: jm.backbone[k] for k in keys}, None, jnp.asarray(ct_o), jnp.asarray(ct_d),
        jnp.asarray(gt), jm.backbone, jm.trainable, jm.occ.occupancy, jm.wcfg,
        dataclasses.replace(jm.rc, t_cull=0.0), jm.infer_budget, _grads_as_state)
    atk = t_atk.FinetuneAttack(tt, full_backbone=full)
    assert list(atk.train_part) == keys
    lt = atk.loss(T(ct_o), T(ct_d), T(gt))
    gt_ = torch.autograd.grad(lt, t_atk._leaves(atk.train_part))
    lim, g_lim = {"fp32": (1e-6, 1e-5), "bf16": (1e-5, 2e-2)}[dtype]
    assert abs(float(lt) - float(lj)) <= lim * abs(float(lj))
    pairs = list(zip(gt_, jax.tree_util.tree_leaves({k: gj[k] for k in keys})))
    assert len(pairs) == (1 if not full else 1 + len(jm.backbone["sigma_net"])
                          + len(jm.backbone["color_net"]))
    for a, b in pairs:
        assert np.abs(np.asarray(b)).max() > 0
        assert rel_l2(a.numpy(), np.asarray(b)) <= g_lim


def test_adam_and_clamp_step_matches_optax():
    rng = np.random.default_rng(5)
    w = [rng.normal(0, 0.1, (64, 2)).astype(np.float32), rng.normal(0, 0.1, (8,)).astype(np.float32)]
    grads = [[rng.normal(size=a.shape).astype(np.float32) * s for a in w] for s in (1.0, 0.3)]
    eps, lr = 1.5e-3, 1e-3
    opt = optax.adam(lr)
    pj = [jnp.asarray(a) for a in w]
    state = opt.init(pj)
    for g in grads:
        upd, state = opt.update([jnp.asarray(a) for a in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        pj = [jnp.clip(p, jnp.asarray(o) - jnp.float32(eps), jnp.asarray(o) + jnp.float32(eps))
              for p, o in zip(pj, w)]
    orig = [T(a.copy()) for a in w]
    leaves = [T(a.copy()).requires_grad_(True) for a in w]
    frozen = T(w[1].copy()).requires_grad_(True)  # a leaf no gradient reaches
    optimizer = t_atk._adam(leaves + [frozen], lr)
    for g in grads:
        for p, a in zip(leaves, g):
            p.grad = T(a)
        t_atk.adam_clamp_step(optimizer, leaves + [frozen], orig + [T(w[1])], eps)
    for p, q in zip(leaves, pj):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=0, atol=1e-7)
    assert torch.equal(frozen.detach(), T(w[1]))
    # two steps of ~lr each: the first leaf's clamp binds
    assert np.abs(leaves[0].detach().numpy() - w[0]).max() == pytest.approx(eps, rel=1e-4)


def _content_loader(tm, n=2, seed=6):
    _, _, ct_o, ct_d, gt = wm_batch(seed=seed)
    return [{"content": {"rays_o": ct_o[None], "rays_d": ct_d[None], "images": gt[None]}}] * n


def test_finetune_attack_changes_only_the_hash_table():
    _, tm, _, tt = _trainers()
    bb0 = t_twm._tree_map(lambda t: t.detach().clone(), tm.backbone)
    tr0 = t_twm._tree_map(lambda t: t.detach().clone(), tm.trainable)
    attacked = t_atk.finetune_attack(tt, _content_loader(tm), steps=3, lr=1e-2, num_rays=64)
    assert not torch.equal(attacked["hash_table"], bb0["hash_table"])
    for k in bb0:
        for a, b, c in zip(t_atk._leaves({k: bb0[k]}), t_atk._leaves({k: attacked[k]}),
                           t_atk._leaves({k: tm.backbone[k]})):
            assert torch.equal(a, c)  # the model's backbone is never written
            if k != "hash_table":
                assert torch.equal(a, b)
    for a, b in zip(t_twm.trainable_leaves(tr0), t_twm.trainable_leaves(tm.trainable)):
        assert torch.equal(a, b)
    full = t_atk.finetune_attack(tt, _content_loader(tm), steps=2, lr=1e-2, num_rays=64,
                                 full_backbone=True)
    assert all(not torch.equal(a, b) for a, b in zip(t_atk._leaves(full), t_atk._leaves(bb0)))


def test_attacked_verification_saves_no_best_checkpoint(tmp_path):
    """``--test --adv_attack --finetune_attack``: each attacked verification
    beats the best score so far, and the best checkpoint is left as it was;
    a verification of the model's own weights saves it."""
    from nerf_signature_tpu_torch.main_nerf_wtmk import run_attacks

    _, tm = make_wm_models()
    opt = _opt(attack_suite=False, adv_attack=True, adv_epsilon=1e-3, adv_steps=2,
               finetune_attack=True, finetune_attack_full=False, finetune_attack_steps=2,
               finetune_attack_lr=1e-2, n_views=1, n_test_bitacc=2, num_images_test=0)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=str(tmp_path),
                                use_checkpoint="scratch", mute=True)
    ro_b, rd_b, *_ = wm_batch()
    content = _content_loader(tm, 1)

    def make_loader(type, n_views, n_test):
        if type == "train":
            return content
        return [{"watermark": {"rays_o_block": ro_b, "rays_d_block": rd_b}}] * n_test

    best = tt.save_checkpoint(best=True)
    with open(best, "rb") as f:
        saved = f.read()
    mtime = os.stat(best).st_mtime_ns
    tt.stats["best_result"] = -1.0  # every score beats it
    run_attacks(opt, tm, tt, make_loader)
    assert tt.stats["best_result"] == -1.0
    with open(best, "rb") as f:
        assert f.read() == saved
    assert os.stat(best).st_mtime_ns == mtime
    os.remove(best)
    acc = tt.test_bitacc(make_loader("test", 1, 2))
    assert tt.stats["best_result"] == acc and os.path.exists(best)


def test_finetune_attack_refuses_an_empty_loader():
    _, _, _, tt = _trainers()
    with pytest.raises(ValueError, match="no batches"):
        t_atk.finetune_attack(tt, [], steps=2)


def test_parameter_attack_stays_in_the_epsilon_ball():
    jm, tm, jt, tt = _trainers()
    eps = 1e-3
    tr0 = t_twm._tree_map(lambda t: t.detach().clone(), tm.trainable)
    attacked = t_atk.parameter_attack(tt, _content_loader(tm, 1), epsilon=eps, steps=3,
                                      num_rays=64)
    a_leaves = t_twm.trainable_leaves(attacked)
    o_leaves = t_twm.trainable_leaves(tr0)
    # within the fp32 ball the clamp computes, o -+ eps
    assert bool(((a_leaves[0] >= o_leaves[0] - eps) & (a_leaves[0] <= o_leaves[0] + eps)).all())
    assert float((a_leaves[0] - o_leaves[0]).abs().max()) > 0.5 * eps  # it moved
    for a, o in zip(a_leaves[1:], o_leaves[1:]):
        assert torch.equal(a, o)  # the decoder: bit-identical
    for a, o in zip(t_twm.trainable_leaves(tm.trainable), o_leaves):
        assert torch.equal(a, o)  # the model's trainable tree is the original
    # the target: the message-free render of the original, as JAX renders it
    atk = t_atk.ParameterAttack(tt, _content_loader(tm, 1), num_rays=64)
    _, _, ct_o, ct_d, _ = wm_batch(seed=6)
    clean = lambda x, d: j_wm.wtmk_field(jm.backbone, jm.trainable, jm.wcfg, x, d, None)
    tj = j_render.render_rays_occ(clean, jm.occ.occupancy, jnp.asarray(ct_o), jnp.asarray(ct_d),
                                  dataclasses.replace(jm.rc, t_cull=0.0),
                                  budget=jm.infer_budget, bg_color=1.0)["image"]
    np.testing.assert_allclose(atk.target.numpy(), np.asarray(tj), rtol=0, atol=1e-4)
