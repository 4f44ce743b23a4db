"""Port parity of K7, the stochastic hash estimators (``stochastic_grad``,
``level_stride``, ``fwd_corners=1``), against the JAX package's
``hash_encode`` on the same numpy inputs (CPU: the plain versions; the
kernels are held against these on the card in test_torch_kernels.py), then
their own properties as the JAX package's tests check them, their scope in
both trainers, both device loops against JAX's on the same samples, and
both CLIs.

Tolerances and why:
  * the corner choice: equal to JAX's on every (level, sample) but those
    whose u lies within 2^-22 of a running corner sum (XLA on the CPU may
    contract ``cum + a*b`` into an FMA; ROADMAP queue 3), which are counted
    (``stochastic_choice(audit=True)``) and left out; on these inputs there
    are none (``MARGIN``).  Resolutions are powers of two, as in the K1
    tests, so the scaled positions are exact in both packages.
  * forward: the 8-corner path equals the port's exact forward bit for bit
    and JAX's to rtol 1e-5 / atol 1e-6 (K1's weight products); the
    one-corner forward equals JAX's exactly (a gathered row, times 1).
  * table gradients: rtol 1e-5 / atol 1e-6 (the scatter's fp32 sum order;
    the square loss's cotangent carries the forward's ulp).  The cotangent
    is scattered unrounded: a single sample's gradient is its cotangent bit
    for bit, which a bf16 rounding would move by up to 2^-9 relative.
  * device loops on JAX's draws: the packages' sample positions differ by
    ulps (FMA contraction), and an ulp of position redraws the corner, so
    the bounds are the one-corner estimator's noise (see each test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.ops import hashenc as j_hash
from nerf_signature_tpu_torch.ops import hashenc as t_hash

T = torch.from_numpy
L, S, M = 4, 12, 384
RES = j_hash.level_resolutions(L, 16, 128)  # 16, 32, 64, 128: powers of two
ADDRESSING = {"hashed": dict(dense=False, shared=False), "dense": dict(dense=True, shared=False),
              "shared": dict(dense=False, shared=True)}
# (level, sample) choices at the FMA margin on these inputs, by addressing
MARGIN = {"hashed": 0, "dense": 0, "shared": 0}


def _inputs(name, F=2, seed=3, m=M):
    a = ADDRESSING[name]
    rng = np.random.default_rng(seed)
    sides = j_hash.level_sides(RES, S, True) if a["dense"] else None
    rows = (int(j_hash.level_row_counts(sides, S).sum()) if sides
            else (1 << S) if a["shared"] else L << S)
    table = rng.uniform(-1, 1, size=(rows, F)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, size=(m, 3)).astype(np.float32)  # clipped to [0, 1]
    return x, table, sides, a["shared"]


def _jax_encode(x, table, sides, shared, **kw):
    return j_hash.hash_encode(jnp.asarray(x), jnp.asarray(table), RES, S, shared_table=shared,
                              dense_sides=sides, **kw)


@pytest.fixture(scope="module")
def jax_rows():
    """JAX's chosen rows [L, M] by addressing: its one-corner forward of a
    table whose row r holds (r, 0), gathered in fp32 (exact below 2^24)."""
    out = {}
    for name in ADDRESSING:
        x, table, sides, shared = _inputs(name)
        index = np.zeros_like(table)
        index[:, 0] = np.arange(table.shape[0], dtype=np.float32)
        f = np.asarray(_jax_encode(x, index, sides, shared, stochastic_grad=True,
                                   fwd_corners=1))
        out[name] = f.reshape(M, L, 2)[..., 0].T.astype(np.int64)
    return out


@pytest.mark.parametrize("name", list(ADDRESSING))
def test_chosen_rows_match_jax_but_at_the_margin(jax_rows, name):
    x, _, sides, shared = _inputs(name)
    rows, phase_bits, margin = t_hash.stochastic_choice(T(x), RES, S, shared, sides, audit=True)
    differ = rows.numpy() != jax_rows[name]
    assert int(margin.sum()) == MARGIN[name]
    assert not (differ & ~margin.numpy()).any()
    assert phase_bits.shape == (M,) and int(phase_bits.max()) < (1 << 24)
    # every corner wins somewhere, and the choice is one of the cell's corners
    corners = np.stack([i.numpy() for i, _ in t_hash._corners(T(x), RES, S, shared, sides,
                                                             torch.float32)])
    hit = corners == rows.numpy()[None]
    assert hit.any(0).all() and hit.any((1, 2)).all()


@pytest.mark.parametrize("gather", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["hashed", "dense"])
def test_stochastic_forward_is_the_exact_forward(name, gather):
    x, table, sides, shared = _inputs(name)
    gd_t, gd_j = (torch.bfloat16, "bfloat16") if gather == "bf16" else (None, None)
    exact = t_hash.hash_encode(T(x), T(table), RES, S, gather_dtype=gd_t, dense_sides=sides)
    for stride in (1, 2):
        st = t_hash.hash_encode(T(x), T(table), RES, S, gather_dtype=gd_t, dense_sides=sides,
                                stochastic_grad=True, level_stride=stride)
        assert torch.equal(st, exact)
    fj = _jax_encode(x, table, sides, shared, gather_dtype=gd_j, stochastic_grad=True)
    np.testing.assert_allclose(exact.numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gather", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(ADDRESSING))
def test_one_corner_forward_matches_jax(name, gather):
    x, table, sides, shared = _inputs(name)
    gd_t, gd_j = (torch.bfloat16, "bfloat16") if gather == "bf16" else (None, None)
    ft = t_hash.hash_encode(T(x), T(table), RES, S, gather_dtype=gd_t, shared_table=shared,
                            dense_sides=sides, stochastic_grad=True, fwd_corners=1)
    fj = _jax_encode(x, table, sides, shared, gather_dtype=gd_j, stochastic_grad=True,
                     fwd_corners=1)
    assert MARGIN[name] == 0  # no choice to leave out
    assert np.array_equal(ft.numpy(), np.asarray(fj))


# (loss, level_stride, gather, fwd_corners, addressing): the linear and the
# square loss, strides 1 and 2 and 3 (which does not divide L = 4: stride 1)
GRAD_CASES = [("linear", 1, "fp32", 8, "hashed"), ("linear", 2, "bf16", 8, "hashed"),
              ("square", 1, "bf16", 8, "dense"), ("square", 2, "fp32", 8, "dense"),
              ("linear", 3, "bf16", 8, "hashed"), ("square", 2, "bf16", 1, "hashed"),
              ("linear", 1, "fp32", 1, "dense"), ("square", 3, "fp32", 1, "shared"),
              ("linear", 2, "bf16", 1, "shared")]


@pytest.mark.parametrize("loss,stride,gather,corners,name", GRAD_CASES)
def test_table_gradient_matches_jax(loss, stride, gather, corners, name):
    x, table, sides, shared = _inputs(name)
    gd_t, gd_j = (torch.bfloat16, "bfloat16") if gather == "bf16" else (None, None)
    w = np.random.default_rng(7).normal(size=(M, L * 2)).astype(np.float32)
    kw = dict(stochastic_grad=True, level_stride=stride, fwd_corners=corners)

    def fj(t):
        f = j_hash.hash_encode(jnp.asarray(x), t, RES, S, gather_dtype=gd_j, shared_table=shared,
                               dense_sides=sides, **kw)
        return jnp.sum(w * (f if loss == "linear" else f * f))

    gj = np.asarray(jax.grad(fj)(jnp.asarray(table)))
    tt = T(table.copy()).requires_grad_(True)
    f = t_hash.hash_encode(T(x), tt, RES, S, gather_dtype=gd_t, shared_table=shared,
                           dense_sides=sides, **kw)
    torch.sum(T(w) * (f if loss == "linear" else f * f)).backward()
    assert tt.grad.dtype == torch.float32 and float(tt.grad.abs().sum()) > 0
    np.testing.assert_allclose(tt.grad.numpy(), gj, rtol=1e-5, atol=1e-6)


def test_gradient_is_the_unrounded_cotangent():
    """Under a bf16 gather K7 adds the fp32 cotangent itself: one sample's
    gradient at its chosen rows is the cotangent bit for bit, where K1's
    backward (and a K7 that rounded) gives the bf16-rounded product."""
    x, table, _, _ = _inputs("hashed", m=1)
    ct = np.float32(1.0 + 2.0 ** -12 + 2.0 ** -20)  # not representable in bf16
    g = np.full((1, L * 2), ct, np.float32)
    grad = t_hash.hash_encode_stoch_bwd_plain(T(x), T(g), table.shape[0], RES, S)
    rows, _ = t_hash.stochastic_choice(T(x), RES, S)
    for lv in range(L):
        assert grad[rows[lv, 0]].tolist() == [float(ct)] * 2
    tt = T(table.copy()).requires_grad_(True)
    t_hash.hash_encode(T(x), tt, RES, S, gather_dtype=torch.bfloat16,
                       stochastic_grad=True).backward(T(g))
    assert torch.equal(tt.grad, grad)
    gj = jax.grad(lambda t: jnp.sum(j_hash.hash_encode(
        jnp.asarray(x), t, RES, S, gather_dtype="bfloat16", stochastic_grad=True) * g))(
        jnp.asarray(table))
    assert np.array_equal(np.asarray(gj), grad.numpy())
    rounded = float(torch.tensor(ct).to(torch.bfloat16).float())
    assert rounded != float(ct)
    k1 = t_hash.hash_encode_bwd_plain(T(x), T(g), table.shape[0], RES, S, torch.bfloat16)
    assert not torch.equal(k1, grad)


# --------------------------------------------------- K7's own properties
PRES = (4.0, 8.0)
PS = 6  # a tiny table: every cell takes many samples


def _prop_table(seed, scale=1.0):
    return (torch.rand((2 << PS, 2), generator=torch.Generator().manual_seed(seed)) * 2e-4
            - 1e-4) * scale


def _grad(x, table, **kw):
    t = table.clone().requires_grad_(True)
    t_hash.hash_encode(x, t, PRES, PS, **kw).sum().backward()
    return t.grad


@pytest.mark.parametrize("corners", [8, 1])
def test_gradient_is_unbiased_in_aggregate(corners):
    """50,000 uniform samples, a linear loss: the one-corner gradient points
    where the exact one does (cosine > 0.98) and conserves its mass (one
    unit a (level, sample), to 1e-3), as JAX's tests hold it."""
    x = torch.rand((50_000, 3), generator=torch.Generator().manual_seed(1))
    table = _prop_table(1)
    a = _grad(x, table).reshape(-1).double()
    b = _grad(x, table, stochastic_grad=True, fwd_corners=corners).reshape(-1).double()
    assert float(a @ b / (a.norm() * b.norm())) > 0.98
    assert float(b.sum()) == pytest.approx(float(a.sum()), rel=1e-3)


def test_one_corner_rows_come_from_the_sample_cell():
    table = _prop_table(2, 1e4)[: 1 << PS]
    x = torch.rand((512, 3), generator=torch.Generator().manual_seed(2))
    out = t_hash.hash_encode(x, table, (4.0,), PS, stochastic_grad=True, fwd_corners=1)
    rows = torch.stack([table[i[0]] for i, _ in t_hash._corners(x, (4.0,), PS, False, None,
                                                              torch.float32)])
    assert (rows == out[None]).all(-1).any(0).all()
    # unbiased in aggregate: the mean one-corner feature is the mean exact one
    x = torch.rand((200_000, 3), generator=torch.Generator().manual_seed(3))
    table = _prop_table(3, 1e4)
    exact = t_hash.hash_encode(x, table, PRES, PS).mean(0)
    sub = t_hash.hash_encode(x, table, PRES, PS, stochastic_grad=True, fwd_corners=1).mean(0)
    scale = float(exact.abs().mean())
    assert float((sub - exact).abs().max()) / scale <= 2e-2


def test_level_stride_subsamples_and_both_phases_occur():
    """A single sample's gradient touches L / stride levels; over 4096
    samples both phases occur (the phase varies per sample, not per cell);
    the aggregate stays unbiased (cosine > 0.97, mass to 5e-2)."""
    table = _prop_table(4)

    def levels(x, stride):
        g = _grad(x, table, stochastic_grad=True, level_stride=stride)
        return (g.abs().reshape(2, -1).sum(1) > 0).numpy()

    one = torch.rand((1, 3), generator=torch.Generator().manual_seed(7))
    assert levels(one, 1).sum() == 2 and levels(one, 2).sum() == 1
    many = torch.rand((4096, 3), generator=torch.Generator().manual_seed(4))
    assert levels(many, 2).all()
    _, phase_bits = t_hash.stochastic_choice(many, PRES, PS)
    keep = t_hash.level_keep(phase_bits, 2, 2)
    assert 0.4 < float(keep[0].float().mean()) < 0.6
    x = torch.rand((50_000, 3), generator=torch.Generator().manual_seed(5))
    a = _grad(x, table).reshape(-1).double()
    b = _grad(x, table, stochastic_grad=True, level_stride=2).reshape(-1).double()
    assert float(a @ b / (a.norm() * b.norm())) > 0.97
    assert float(b.sum()) == pytest.approx(float(a.sum()), rel=5e-2)


def test_atomics_model_counts_one_add_per_kept_level_sample():
    """``kernel_cases.k7_bwd_atomics`` (the atomics K7's backward issues, as
    its design groups them): at most one a (level, sample), at most K1's
    count of the same inputs over 8, half of them at stride 2 in
    expectation; rows of one warp that coincide at a coarse level add once."""
    from nerf_signature_tpu_torch.kernel_cases import k1_bwd_atomics, k7_bwd_atomics

    x = torch.rand((4096, 3), generator=torch.Generator().manual_seed(6))
    g = torch.randn((4096, L * 2), generator=torch.Generator().manual_seed(6))
    k7 = k7_bwd_atomics(x, g, 2, RES, S)
    k1 = k1_bwd_atomics(x, g, 2, RES, S, torch.float32)
    assert 0 < k7 <= 4096 * L and k7 * 4 < k1
    half = k7_bwd_atomics(x, g, 2, RES, S, level_stride=2)
    assert 0.4 * k7 < half < 0.6 * k7
    ungrouped = k7_bwd_atomics(x, g, 2, RES, S, combine=0)
    assert ungrouped == 4096 * L and k7 < ungrouped


# ------------------------------------------------------------- trainers
def _spy_corners(monkeypatch):
    """Record the fwd_corners of every backbone hash encode."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp

    seen = []
    real = t_ngp.hash_encode

    def spy(*a, **kw):
        seen.append(kw.get("fwd_corners", 8))
        return real(*a, **kw)

    monkeypatch.setattr(t_ngp, "hash_encode", spy)
    return seen


def _k7_models(kind):
    from test_torch_render import make_models
    from test_torch_wm_train import make_wm_models

    jm, tm = make_models("fp32", 1.0) if kind == "clean" else make_wm_models("fp32")
    for m in (jm, tm):
        cfg = m.cfg if kind == "clean" else m.wcfg.ngp
        cfg = dataclasses.replace(cfg, stochastic_hash_grad=True, hash_level_stride=2)
        if kind == "clean":
            m.cfg = cfg
        else:
            m.wcfg = dataclasses.replace(m.wcfg, ngp=cfg)
    return jm, tm


def test_one_corner_forward_is_scoped_to_the_clean_step(monkeypatch):
    """--hash_fwd_corners 1: the step's encode takes one corner, the grid
    update and the evaluation render eight; the model's config stays exact."""
    from nerf_signature_tpu_torch.train import trainer as t_trainer
    from test_torch_train import _opt, batch

    _, tm = _k7_models("clean")
    tt = t_trainer.Trainer("ngp", _opt(hash_fwd_corners=1), tm, workspace=None, mute=True)
    assert tt.cfg_train.hash_fwd_corners == 1 and tm.cfg.hash_fwd_corners == 8
    seen = _spy_corners(monkeypatch)
    ro, rd, images = batch()
    bg, noise = tt.draws(ro.shape[0], True)
    tt._train_step(T(ro), T(rd), T(images), bg, noise, tt._rc_train(), tm.train_budget)
    assert set(seen) == {1}
    seen.clear()
    tm.update_extra_state(full=True)
    tm.render(ro[:32], rd[:32])
    assert seen and set(seen) == {8}


def test_one_corner_forward_is_scoped_to_the_watermark_step(monkeypatch):
    """The watermark step's backbone encode takes one corner (wcfg_train);
    the verification decode stays exact; the message encode is always
    K1's exact one."""
    from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
    from test_torch_wm_train import _opt, wm_batch

    _, tm = _k7_models("wm")
    tt = t_twm.WatermarkTrainer("wm", _opt(hash_fwd_corners=1), tm, workspace=None, mute=True)
    assert tt.wcfg_train.ngp.hash_fwd_corners == 1 and tm.wcfg.ngp.hash_fwd_corners == 8
    seen = _spy_corners(monkeypatch)
    ro_b, rd_b, ct_o, ct_d, gt = (T(np.ascontiguousarray(v)) for v in wm_batch())
    tt._train_step(ro_b, rd_b, ct_o, ct_d, gt, torch.tensor([1, 0, 1], dtype=torch.int32),
                   None, tm.rc)
    assert set(seen) == {1}
    seen.clear()
    tt._decode(ro_b, rd_b, np.array([0, 1, 1], np.int32), "none")
    assert seen and set(seen) == {8}


# ------------------------------------------------------------ the device loops
CLEAN_STEPS = 8
WM_STEPS = 3


def test_clean_loop_with_k7_matches_jax():
    """``device_train_loop`` with --stochastic_hash_grad --hash_level_stride 2
    --hash_fwd_corners 1 against JAX's loop on JAX's draws, the grid updated
    at step 0.  An ulp of a sample's position redraws its corners, and the
    two packages' positions differ by ulps (FMA contraction, ROADMAP queue
    3; inside JAX's scan the rays too), so the one-corner estimates differ
    sample by sample: the bounds are the estimator's noise, a few times
    what was measured on the CPU (losses 1.3e-2 relative, params <= 4.4e-2
    and EMA <= 1.1e-2 relative L2, against 2.4e-7 / 0 / 0 for the exact
    loop on the same draws): losses 5e-2, params 0.15, EMA 4e-2."""
    from nerf_signature_tpu.train import device_loop as j_dl
    from nerf_signature_tpu.train import trainer as j_trainer
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from nerf_signature_tpu_torch.train import trainer as t_trainer
    from test_torch_device_loop import (BUDGET, DENSITY_THRESH, H, N_RAYS, P, W, _clean_opt,
                                        _leaves_j, _leaves_t, _views, jax_clean_draws)
    from test_torch_train_ops import rel_l2

    jm, tm = _k7_models("clean")
    for m in (jm, tm):
        m.train_budget = BUDGET
        m.density_thresh = DENSITY_THRESH
    opt = _clean_opt(compact_frac=0, hash_fwd_corners=1)
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    assert jt.cfg_train.hash_fwd_corners == tt.cfg_train.hash_fwd_corners == 1
    poses, images, intr = _views(4)
    key = jax.random.PRNGKey(7)
    out = j_dl.device_train_loop(
        jm.params, jt.ema_params, jt.opt_state, jm.occ, jnp.asarray(poses),
        jnp.asarray(images.reshape(P, -1, 4)), jnp.asarray(intr), key, 0, jt.cfg_train,
        jt._rc_train(), BUDGET, jt.optimizer.update, True, jt.ema_decay, CLEAN_STEPS, N_RAYS, H,
        W, update_interval=16, density_thresh=jm.density_thresh, grid_full_until=16)
    draws, grid = jax_clean_draws(key, CLEAN_STEPS, tm.occ.density.shape[0], {0: True})
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    stats = t_dl.device_train_loop(tt, data, CLEAN_STEPS, draws=draws,
                                   grid_draws=lambda step, full: grid[step])
    np.testing.assert_allclose(stats.losses, np.asarray(out[4]), rtol=5e-2)
    for pj, pt in zip(_leaves_j(out[0]), _leaves_t(tm.params)):
        assert rel_l2(pt, pj) <= 0.15
    for ej, et in zip(_leaves_j(out[1]), _leaves_t(tt.ema_params)):
        assert rel_l2(et, ej) <= 4e-2
    assert np.array_equal(np.asarray(out[3].occupancy), tm.occ.occupancy.numpy())


def test_wm_loop_with_k7_matches_jax():
    """``wm_device_loop`` with --stochastic_hash_grad --hash_fwd_corners 1
    (the backbone's encode takes one corner, the message's stays exact)
    against JAX's loop on JAX's draws, 3 steps.  As in the clean loop, an
    ulp of position redraws a corner, so the content renders differ sample
    by sample; Adam (eps 1e-15) then steps each message-table entry by about
    lr in the sign of gradients that differ, so the tables agree only
    loosely.  Measured on the CPU: losses 1.35e-2 relative, tables 0.32
    relative L2 (the exact loop: 1.4e-4 and 4.3e-3).  Bounds: losses 5e-2,
    tables 0.6."""
    from nerf_signature_tpu.train import trainer_wtmk as j_twm
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
    from test_torch_device_loop import H, P, W, WM_RAYS, _views, _wm_opt
    from test_torch_train_ops import rel_l2
    from test_torch_wm_train import wm_batch

    jm, tm = _k7_models("wm")
    opt = _wm_opt(distortion="none", hash_fwd_corners=1)
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    assert jt.wcfg_train.ngp.hash_fwd_corners == tt.wcfg_train.ngp.hash_fwd_corners == 1
    ro_b, rd_b, *_ = wm_batch(seed=3)
    poses, images, intr = _views(3, seed=5)
    key = jax.random.PRNGKey(21)
    D = tm.wcfg.message_dim
    (jtr, _, lj, lwj, lij) = j_twm._wm_device_loop(
        jm.backbone, jm.trainable, jt.opt_state, jm.occ.occupancy, jnp.asarray(ro_b),
        jnp.asarray(rd_b), jnp.asarray(poses), jnp.asarray(images.reshape(P, -1, 3)),
        jnp.asarray(intr), key, jnp.float32(opt.lambda_w), jnp.float32(opt.lambda_i),
        jt.wcfg_train, jm.rc, jt.content_budget, jm.infer_budget, jt.optimizer.update,
        "none", "bce", WM_STEPS, WM_RAYS, H, W)
    msg, pidx, pix = [], [], []
    for k in jax.random.split(key, WM_STEPS):
        km, kp, ki, _ = jax.random.split(k, 4)
        msg.append(np.asarray(jax.random.randint(km, (D,), 0, 2)))
        pidx.append(int(jax.random.randint(kp, (), 0, P)))
        pix.append(np.asarray(jax.random.randint(ki, (WM_RAYS,), 0, H * W)))
    draws = t_dl.WmDraws(T(np.stack(msg).astype(np.int32)), torch.tensor(pidx),
                         T(np.stack(pix).astype(np.int64)), None)
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    lt, lwt, lit = t_dl.wm_device_loop(tt, data, T(np.ascontiguousarray(ro_b)),
                                       T(np.ascontiguousarray(rd_b)), WM_STEPS, draws=draws)
    for a, b in ((lt, lj), (lwt, lwj), (lit, lij)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-2)
    assert rel_l2(tm.trainable["msg_tables"].detach().numpy(),
                  np.asarray(jtr["msg_tables"])) <= 0.6


# ---------------------------------------------------------------- the CLIs
def write_image_scene(tmp_path):
    """A tiny Blender-style scene with random 3-channel images for train,
    val and test (``test_torch_wm_io.write_scene`` plus the PNGs)."""
    import json
    import os

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
    return scene


def test_clis_train_with_the_stochastic_estimators(tmp_path):
    """``main_nerf --cpu --stochastic_hash_grad --hash_level_stride 2
    --hash_fwd_corners 1`` per step and through the loop, and
    ``main_nerf_wtmk --cpu --stochastic_hash_grad --hash_fwd_corners 1``."""
    import glob
    import os

    from nerf_signature_tpu_torch import main_nerf as t_main
    from nerf_signature_tpu_torch import main_nerf_wtmk as t_main_wm
    from test_torch_device_loop import _clean_ckpt, _jax_reads
    from test_torch_wm_io import _cli_flags

    scene = write_image_scene(tmp_path)
    k7 = ["--stochastic_hash_grad", "--hash_fwd_corners", "1"]
    base = [scene, "--cpu", "-O", "--iters", "4", "--grid_size", "16", "--num_rays", "32",
            "--bound", "1.0", "--scale", "1.0", "--dt_gamma", "0", "--min_near", "0.05",
            "--density_thresh", "0.01", "--train_budget", "16", "--infer_budget", "16",
            "--max_steps", "64", "--n_levels", "2", "--hash_level_stride", "2"] + k7
    for name, extra in (("step", []), ("loop", ["--steps_per_dispatch", "2"])):
        ws = str(tmp_path / name)
        assert t_main.main(base + ["--workspace", ws] + extra) == 0
        assert "[eval]" in open(os.path.join(ws, "log_ngp.txt")).read()
    ws = str(tmp_path / "wm")
    flags = _cli_flags(scene, ws, _clean_ckpt(tmp_path), iters=4) + k7 + ["--num_rays", "32"]
    assert t_main_wm.main(flags) == 0
    ckpts = sorted(glob.glob(os.path.join(ws, "checkpoints", "ngp_ep*.ckpt")))
    assert int(_jax_reads(ckpts[-1])["global_step"]) == 4
