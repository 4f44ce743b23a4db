"""Port parity of the watermark train step and the trainer: ``_wm_step_loss``
(loss and every ``trainable`` gradient) on the same samples and end to end,
one whole ``_wtmk_train_step`` with Adam, ``resolve_auto_compaction``, the
decoded logits of ``test_bitacc`` on fixed messages and its message draws,
each against the JAX package on the same inputs (CPU: the plain versions of
the kernels).  Tiny sizes (see test_torch_wm_ops): 3 key blocks of 4x4 rays
and 64 content rays on a ball grid of 16^3 cells, budget 16.

"On the same samples": the port's renderer is handed the JAX march's
samples (``march_rays_aabb`` patched to run JAX's ``march_rays``), so only
the field, compositor, decoder and loss are compared.  End to end each
package marches; XLA on the CPU contracts ``t0 + i*dt`` and ``o + t*d``
into FMAs and the port does not (ROADMAP queue 3), so sample positions
differ by an ulp, which the finest hash level turns into small feature
differences.

Tolerances and why (relative L2 per trainable leaf):
  * same samples, fp32: loss 1e-6, message tables 1e-5, decoder leaves
    1e-4 (conv sums in another order through 9 batch norms).  A conv bias
    before a batch norm has a zero gradient in exact arithmetic: those
    leaves are held to 1e-5 of the largest leaf's norm instead.
  * same samples, bf16: loss 1e-5; message tables 1e-3 and decoder leaves
    1e-3 (the same bf16 rounding points in both packages; a bf16 step where
    an fp32 sum differs by an ulp).
  * end to end, fp32: loss 1e-5, every leaf 1e-3 (the FMA ulps).
  * after Adam's first step (eps 1e-15) each update is -lr * sign(g): params
    are compared where |g| exceeds 1e-2 of the leaf's RMS gradient.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu import api as j_api
from nerf_signature_tpu.ops import intersect as j_int
from nerf_signature_tpu.ops import marching as j_march
from nerf_signature_tpu.train import trainer_wtmk as j_twm
from nerf_signature_tpu_torch import api as t_api
from nerf_signature_tpu_torch.render import renderer as t_render
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
from test_torch_render import ball_occupancy, view_rays
from test_torch_wm_ops import port_params, rel_l2, wm_cfgs, wm_params

T = torch.from_numpy
GRID = 16
BUDGET = 16
BLOCK = 4
LAMBDA_W, LAMBDA_I = 0.5, 1.0


def make_wm_models(dtype="fp32", seed=0):
    jcfg, tcfg = wm_cfgs(dtype)
    kw = dict(density_thresh=0.01, max_steps=64, grid_size=GRID, train_budget=BUDGET,
              infer_budget=BUDGET)
    jm = j_api.WatermarkModel(jcfg, **kw)
    tm = t_api.WatermarkModel(tcfg, device="cpu", **kw)
    p = wm_params(jcfg, seed)
    jm.backbone = jax.tree_util.tree_map(jnp.asarray, p["backbone"])
    jm.trainable = jax.tree_util.tree_map(jnp.asarray, p["trainable"])
    tm.backbone, tm.trainable = port_params(p)
    occ = ball_occupancy(1.0, H=GRID)
    jm.occ = jm.occ._replace(occupancy=jnp.asarray(occ))
    tm.occ = tm.occ._replace(occupancy=torch.from_numpy(occ))
    return jm, tm


def wm_batch(seed=0, n_content=64):
    """Key-block ray bundles [3, 4, 4, 3] cut from one view of the ball,
    content rays of another, random pseudo-GT pixels."""
    rays = view_rays(1.0, n=2, res=20, seed=seed)
    ro = rays["rays_o"][0].reshape(20, 20, 3)
    rd = rays["rays_d"][0].reshape(20, 20, 3)
    corners = [(4, 4), (8, 10), (12, 6)]
    ro_b = np.stack([ro[r:r + BLOCK, c:c + BLOCK] for r, c in corners])
    rd_b = np.stack([rd[r:r + BLOCK, c:c + BLOCK] for r, c in corners])
    rng = np.random.default_rng(seed)
    idx = rng.permutation(400)[:n_content]
    ct_o, ct_d = rays["rays_o"][1][idx], rays["rays_d"][1][idx]
    gt = rng.uniform(size=(n_content, 3)).astype(np.float32)
    return ro_b, rd_b, ct_o, ct_d, gt


def _opt(**kw):
    d = dict(seed=0, iters=100, lr=1e-2, lambda_w=LAMBDA_W, lambda_i=LAMBDA_I, loss_w="bce",
             distortion="none", message_dim=3, devices=1, num_rays=64, max_ray_batch=4096,
             compact_frac=0, group_budget=0, bitacc_batch=4)
    d.update(kw)
    return types.SimpleNamespace(**d)


def jax_march_into_port(monkeypatch):
    """Make the port's renderer march with JAX's ``march_rays``."""
    def march(rays_o, rays_d, aabb, occupancy, *, min_near, bound, dt_gamma=0.0,
              max_steps=1024, n_cand=None, budget=128, prefilter=None, group_budget=None,
              coarse=None, noise=None, t_cull=0.0, plain=False):
        ro, rd = jnp.asarray(rays_o.detach().numpy()), jnp.asarray(rays_d.detach().numpy())
        nears, fars = j_int.near_far_from_aabb(ro, rd, jnp.asarray(np.asarray(aabb, np.float32)),
                                               min_near)
        m = j_march.march_rays(ro, rd, jnp.asarray(occupancy.numpy()), nears, fars,
                               bound=bound, dt_gamma=dt_gamma, max_steps=max_steps,
                               n_cand=n_cand, budget=budget, grid_size=occupancy.shape[-1],
                               prefilter=prefilter, group_budget=group_budget, t_cull=t_cull)
        out = {k: T(np.array(v)) for k, v in m.items()}
        out.update(nears=T(np.array(nears)), fars=T(np.array(fars)))
        return out

    monkeypatch.setattr(t_render, "march_rays_aabb", march)


def jax_loss_and_grads(jm, batch, message, budget=BUDGET):
    ro_b, rd_b, ct_o, ct_d, gt = (jnp.asarray(v) for v in batch)

    def loss_fn(tr):
        return j_twm._wm_step_loss(
            jm.backbone, tr, jm.occ.occupancy, ro_b, rd_b, ct_o, ct_d, gt,
            jnp.asarray(message), jax.random.PRNGKey(0), LAMBDA_W, LAMBDA_I, jm.wcfg, jm.rc,
            budget, BUDGET, "none", j_twm.make_loss_w("bce"))

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(jm.trainable)
    return float(loss), aux, grads


def port_loss_and_grads(tm, batch, message, budget=BUDGET):
    ro_b, rd_b, ct_o, ct_d, gt = (T(np.ascontiguousarray(v)) for v in batch)
    leaves = t_twm.trainable_leaves(tm.trainable)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    loss, aux = t_twm._wm_step_loss(
        tm.backbone, tm.trainable, tm.occ.occupancy, ro_b, rd_b, ct_o, ct_d, gt,
        torch.as_tensor(message), None, LAMBDA_W, LAMBDA_I, tm.wcfg, tm.rc, budget, BUDGET,
        "none", t_twm.make_loss_w("bce"))
    loss.backward()
    return float(loss), aux, t_twm._tree_map(lambda t: t.grad, tm.trainable)


def grad_pairs(gj, gt):
    """(name, port, jax) per trainable leaf, HWIO on both sides."""
    gt_j = t_ckpt.trainable_to_jax(gt)
    flat_j = jax.tree_util.tree_flatten_with_path(gj)[0]
    flat_t = jax.tree_util.tree_leaves(gt_j)
    return [(jax.tree_util.keystr(k), np.asarray(b), np.asarray(a))
            for (k, a), b in zip(flat_j, flat_t)]


def check_grads(gj, gt, msg_bound, dec_bound):
    pairs = grad_pairs(gj, gt)
    scale = max(np.linalg.norm(a) for _, _, a in pairs)
    for name, b, a in pairs:
        bound = msg_bound if "msg_tables" in name else dec_bound
        if np.linalg.norm(a) > 1e-5 * scale:
            assert rel_l2(b, a) <= bound, (name, rel_l2(b, a))
        else:  # a conv bias before a batch norm
            assert np.linalg.norm(b) <= 1e-5 * scale, name


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_wm_step_loss_and_grads_match_jax_on_the_same_samples(monkeypatch, dtype):
    jax_march_into_port(monkeypatch)
    jm, tm = make_wm_models(dtype)
    batch = wm_batch()
    message = np.array([1, 0, 1], np.int32)
    lj, (lwj, lij, dj), gj = jax_loss_and_grads(jm, batch, message)
    lt, (lwt, lit, dt), gt = port_loss_and_grads(tm, batch, message)
    lim = {"fp32": 1e-6, "bf16": 1e-5}[dtype]
    assert abs(lt - lj) <= lim * abs(lj)
    assert abs(float(lit) - float(lij)) <= lim * abs(float(lij)) + 1e-9
    np.testing.assert_allclose(dt.detach().numpy(), np.asarray(dj), rtol=1e-4, atol=1e-5)
    b = {"fp32": (1e-5, 1e-4), "bf16": (1e-3, 1e-3)}[dtype]
    check_grads(gj, gt, *b)
    # the unselected tables take exactly zero gradient
    g = gt["msg_tables"]
    for i, bit in enumerate(message):
        assert g[i, bit].abs().max() > 0 and not g[i, 1 - bit].any()


@pytest.mark.parametrize("two_renders", [False, True])
def test_wm_step_loss_matches_jax_end_to_end(two_renders):
    """Each package marches; one render of blocks + content, or two
    (``--wm_content_budget`` differing from the block budget)."""
    jm, tm = make_wm_models("fp32")
    batch = wm_batch(seed=1)
    message = np.array([0, 1, 1], np.int32)
    budget = 2 * BUDGET if two_renders else BUDGET
    lj, _, gj = jax_loss_and_grads(jm, batch, message, budget)
    lt, _, gt = port_loss_and_grads(tm, batch, message, budget)
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    check_grads(gj, gt, 1e-3, 1e-3)


def test_msg_reg_term_matches_jax():
    jm, tm = make_wm_models("fp32")
    ro_b, rd_b, ct_o, ct_d, gt = wm_batch()
    message = np.array([1, 1, 0], np.int32)
    lj, _ = j_twm._wm_step_loss(
        jm.backbone, jm.trainable, jm.occ.occupancy, *(jnp.asarray(v) for v in
                                                       (ro_b, rd_b, ct_o, ct_d, gt)),
        jnp.asarray(message), jax.random.PRNGKey(0), 0.0, 0.0, jm.wcfg, jm.rc, BUDGET, BUDGET,
        "none", j_twm.make_loss_w("bce"), lambda_msg_reg=jnp.float32(3.0))
    lt, _ = t_twm._wm_step_loss(
        tm.backbone, tm.trainable, tm.occ.occupancy, *(T(np.ascontiguousarray(v)) for v in
                                                       (ro_b, rd_b, ct_o, ct_d, gt)),
        torch.as_tensor(message), None, 0.0, 0.0, tm.wcfg, tm.rc, BUDGET, BUDGET, "none",
        t_twm.make_loss_w("bce"), lambda_msg_reg=3.0)
    assert float(lj) > 0 and abs(float(lt) - float(lj)) <= 1e-5 * float(lj)


def test_wtmk_train_step_matches_jax(monkeypatch):
    """One whole step: loss, decoded logits, Adam's update of every leaf."""
    jax_march_into_port(monkeypatch)
    jm, tm = make_wm_models("fp32")
    opt = _opt()
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    batch = wm_batch(seed=2)
    message = np.array([1, 0, 0], np.int32)
    _, _, gj = jax_loss_and_grads(jm, batch, message)
    w0 = jax.tree_util.tree_map(np.asarray, jm.trainable)
    ro_b, rd_b, ct_o, ct_d, gt = (jnp.asarray(v) for v in batch)
    (jm.trainable, jt.opt_state, lj, lwj, lij, dj) = j_twm._wtmk_train_step(
        jm.backbone, jm.trainable, jt.opt_state, jm.occ.occupancy, ro_b, rd_b, ct_o, ct_d, gt,
        jnp.asarray(message), jax.random.PRNGKey(0), jnp.float32(LAMBDA_W),
        jnp.float32(LAMBDA_I), jm.wcfg, jm.rc, BUDGET, BUDGET, jt.optimizer.update, "none",
        "bce")
    lt, lwt, lit, dt = tt._train_step(*(T(np.ascontiguousarray(v)) for v in batch),
                                      torch.as_tensor(message), None, tm.rc)
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-5)
    assert tt.opt_count() == 1 and int(jt.opt_state[0].count) == 1
    lr = opt.lr
    after_t = t_ckpt.trainable_to_jax(tm.trainable)
    leaves = zip(jax.tree_util.tree_leaves(gj), jax.tree_util.tree_leaves(w0),
                 jax.tree_util.tree_leaves(jm.trainable), jax.tree_util.tree_leaves(after_t))
    scale = max(np.linalg.norm(np.asarray(g)) for g in jax.tree_util.tree_leaves(gj))
    for g, w, pj, pt in leaves:
        g, pj = np.asarray(g), np.asarray(pj)
        if np.linalg.norm(g) <= 1e-5 * scale:
            continue  # a conv bias before a batch norm: its gradient's sign is noise
        sure = np.abs(g) > 1e-2 * np.sqrt(np.mean(g**2))
        np.testing.assert_allclose(pt[sure], pj[sure], rtol=0, atol=1e-6)
        np.testing.assert_allclose(pt[sure], (w - lr * np.sign(g))[sure], rtol=0, atol=1e-6)
    # table entries no sample touched (the unselected tables among them) stay
    g, w = np.asarray(gj["msg_tables"]), w0["msg_tables"]
    assert (g == 0).mean() > 0.5
    assert np.array_equal(after_t["msg_tables"][g == 0], w[g == 0])


class _ProbeLoader:
    def __init__(self):
        from nerf_signature_tpu_torch.data.rays import rand_poses

        self.poses = rand_poses(np.random.default_rng(3), 2, radius=2.2)
        self.H = self.W = 24
        fl = 24 / (2 * np.tan(0.4))
        self.intrinsics = np.array([fl, fl, 12.0, 12.0])


def test_resolve_auto_compaction_matches_jax(monkeypatch):
    import nerf_signature_tpu.data.rays as j_rays

    real = j_rays.get_rays
    # the probe's pixels: the port seeds them with --seed, JAX leaves them
    # unseeded; hand JAX the same generator
    monkeypatch.setattr(j_rays, "get_rays", lambda *a, **k: real(
        *a, **dict(k, rng=np.random.default_rng(0))))
    jm, tm = make_wm_models("fp32")
    opt = _opt(compact_frac=-1, group_budget=-1)
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    loader = _ProbeLoader()
    jt.resolve_auto_compaction(loader)
    tt.resolve_auto_compaction(loader)
    assert 0 < tm.rc.compact_frac < 1
    assert tm.rc.compact_frac == jm.rc.compact_frac
    assert tm.rc.group_budget == jm.rc.group_budget >= 16


def test_bitacc_decoded_logits_match_jax_per_message(monkeypatch):
    """The JAX decode vmaps over messages (batch statistics per message);
    the port decodes message by message: the same logits."""
    jax_march_into_port(monkeypatch)
    jm, tm = make_wm_models("fp32")
    opt = _opt()
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    ro_b, rd_b, *_ = wm_batch()
    messages = np.array([[1, 0, 1], [0, 0, 1], [1, 1, 1], [0, 1, 0]], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), len(messages))
    dj = np.asarray(j_twm._wtmk_decode_blocks_batched(
        jm.backbone, jm.trainable, jm.occ.occupancy, jnp.asarray(ro_b), jnp.asarray(rd_b),
        jnp.asarray(messages), keys, jm.wcfg, jt._rc_eval(), jm.infer_budget, "none"))
    wm = {"rays_o_block": ro_b, "rays_d_block": rd_b}
    for msg, d in zip(messages, dj):
        _, dt = tt.eval_blocks(wm, msg)
        np.testing.assert_allclose(dt, d, rtol=1e-4, atol=1e-5)


def test_test_bitacc_draws_the_messages_jax_draws(monkeypatch):
    jm, tm = make_wm_models("fp32")
    opt = _opt(bitacc_batch=4)
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    seen_j, seen_t = [], []

    def fake_j(*args, **kw):
        msgs = np.asarray(args[5])
        seen_j.append(msgs)
        return np.zeros((len(msgs), 3, 1), np.float32)

    monkeypatch.setattr(j_twm, "_wtmk_decode_blocks_batched", fake_j)
    monkeypatch.setattr(tt, "_decode", lambda ro, rd, message, kind: (
        seen_t.append(np.asarray(message)), (None, torch.zeros((3, 1))))[1])
    ro_b, rd_b, *_ = wm_batch()
    loader = [{"watermark": {"rays_o_block": ro_b, "rays_d_block": rd_b}}] * 10
    jt.test_bitacc(loader)
    tt.test_bitacc(loader)
    used_j = np.concatenate(seen_j)[:10]
    assert np.array_equal(np.stack(seen_t), used_j)
    assert tt.metrics_message[0].N == 10


def test_trainer_refuses_unported_paths():
    _, tm = make_wm_models("fp32")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_twm.WatermarkTrainer("wm", _opt(devices=2), tm, workspace=None, mute=True)
    # --hash_fwd_corners 1 is ported (K7) and, as in JAX, needs
    # --stochastic_hash_grad on the backbone's config
    with pytest.raises(ValueError, match="requires --stochastic_hash_grad"):
        t_twm.WatermarkTrainer("wm", _opt(hash_fwd_corners=1), tm, workspace=None, mute=True)
    # --lambda_ssim without patches: JAX's ValueError
    with pytest.raises(ValueError, match="patch_size > 1"):
        t_twm.WatermarkTrainer("wm", _opt(lambda_ssim=0.1), tm, workspace=None, mute=True)
    # the options the port runs construct (the SSIM patch guard since it was
    # ported)
    for kw in ({}, dict(patch_size=4), dict(patch_size=4, lambda_ssim=0.1)):
        t_twm.WatermarkTrainer("wm", _opt(**kw), tm, workspace=None, mute=True)
    # the paper's baselines are ported: --finetune_decoder, --copyrnerf and
    # --whole_image_wm construct, each with its decoder width
    jcfg, tcfg = wm_cfgs()
    kw = dict(density_thresh=0.01, max_steps=64, grid_size=GRID, train_budget=BUDGET,
              infer_budget=BUDGET, device="cpu")
    for mode in (dict(finetune_decoder=True), dict(copyrnerf=True), dict(whole_image=True)):
        wcfg = dataclasses.replace(tcfg, **mode)
        model = t_api.WatermarkModel(wcfg, **kw)
        t_twm.WatermarkTrainer("wm", _opt(), model, workspace=None, mute=True)
        whole = mode.keys() & {"copyrnerf", "whole_image"}
        assert wcfg.decoder.num_bits == (tcfg.message_dim if whole else 1)
        assert ("msg_mlp" in model.trainable) == ("copyrnerf" in mode)
    # --lambda_msg_reg regularises the msg tables, which CopyRNeRF lacks:
    # JAX's ValueError
    model = t_api.WatermarkModel(dataclasses.replace(tcfg, copyrnerf=True), **kw)
    with pytest.raises(ValueError, match="no msg_tables in its trainable subtree"):
        t_twm.WatermarkTrainer("wm", _opt(lambda_msg_reg=0.1), model, workspace=None, mute=True)


def test_density_fn_is_message_free_and_equals_the_backbones():
    _, tm = make_wm_models("fp32")
    x = T(np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32))
    clean = t_api.NGPModel(tm.cfg, grid_size=GRID, device="cpu")
    clean.params = tm.backbone
    assert torch.equal(tm.density_fn(x), clean.density_fn(x))
    with_msg = tm.render(x[:8] * 0 + T(np.array([0, 0, -2.2], np.float32)),
                         T(np.tile(np.array([0, 0, 1], np.float32), (8, 1))), [1, 0, 1])
    without = tm.render(x[:8] * 0 + T(np.array([0, 0, -2.2], np.float32)),
                        T(np.tile(np.array([0, 0, 1], np.float32), (8, 1))))
    assert not torch.equal(with_msg["image"], without["image"])
