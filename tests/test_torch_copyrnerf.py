"""Port parity of the CopyRNeRF baseline (``--copyrnerf``): ``freq_encode``
and ``copyrnerf_color`` (blend and ``replace``), K10's plain version
against JAX's concatenated MLP input, ``wtmk_field`` in CopyRNeRF mode, one
watermark step's loss and msg-MLP / decoder gradients, a K-step device loop
and the checkpoints both ways, each against the JAX package on the same
numpy inputs (CPU: the plain versions of the kernels).  Tiny sizes (see
test_torch_wm_ops): message_dim 4, a whole key image of 20 x 20 rays (the
decoder's input: ``wm_rays`` strides it by 1) and 64 content rays on a ball
grid of 16^3 cells, budget 16.

Tolerances and why (fp32):
  * ``freq_encode``, K10's input, the colour: 1e-5 absolute; XLA's and
    PyTorch's CPU sin/cos of arguments up to 2^9 pi ~ 1608 rad differ by
    an ulp, and the MLP's 256-wide sums run in another order (measured:
    6.0e-8 on the encoding and the input, 6.6e-7 on the colour).
  * ``wtmk_field`` in CopyRNeRF mode: sigma bit-equal with and without a
    message; rgb 1e-5 absolute against JAX.
  * one step on the same samples: loss 1e-6 relative; every msg-MLP and
    decoder leaf 1e-4 relative L2 (the MLP's weight gradients sum products
    256 wide over every sample, the decoder's convs through 9 batch norms,
    each in another order; measured <= 1.4e-5 on the MLP); a conv bias
    before a batch norm, zero in exact arithmetic, is held to 1e-5 of the
    largest gradient.
  * the device loop, 4 steps with the noise distortion: as
    test_torch_device_loop's watermark loop and for the same reasons (Adam
    with eps 1e-15 turns gradient ulps into sign flips that the decoder's
    batch norms carry): the first two losses 1e-5, the others 1e-3
    relative; msg-MLP and decoder leaves 1e-2 relative L2, a conv bias
    before a batch norm moving at most lr a step.
  * checkpoints: bit-equal trainable leaves and Adam moments.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu import api as j_api
from nerf_signature_tpu.models import copyrnerf as j_crn
from nerf_signature_tpu.models import watermark as j_wm
from nerf_signature_tpu.train import trainer_wtmk as j_twm
from nerf_signature_tpu_torch import api as t_api
from nerf_signature_tpu_torch.models import copyrnerf as t_crn
from nerf_signature_tpu_torch.models import watermark as t_wm
from nerf_signature_tpu_torch.ops import copyrnerf as t_k10
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import device_loop as t_dl
from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
from test_torch_render import ball_occupancy, view_rays
from test_torch_train_ops import rel_l2
from test_torch_wm_ops import port_params, wm_cfgs
from test_torch_wm_train import jax_march_into_port

T = torch.from_numpy
GRID = 16
BUDGET = 16
D_BITS = 4
RES = 20
LAMBDA_W, LAMBDA_I = 0.5, 1.0


def make_mode_models(mode, dtype="fp32", seed=0, message_dim=D_BITS):
    """(JAX model, port model) of the watermark config with ``mode``'s
    fields set, from JAX's init (backbone table at U(+-1), msg tables at
    U(+-0.1) where there are any), on the ball grid."""
    jcfg, tcfg = wm_cfgs(dtype, message_dim=message_dim)
    jcfg, tcfg = dataclasses.replace(jcfg, **mode), dataclasses.replace(tcfg, **mode)
    kw = dict(density_thresh=0.01, max_steps=64, grid_size=GRID, train_budget=BUDGET,
              infer_budget=BUDGET)
    jm = j_api.WatermarkModel(jcfg, **kw)
    tm = t_api.WatermarkModel(tcfg, device="cpu", **kw)
    p = jax.tree_util.tree_map(np.asarray,
                               j_wm.init_watermark_params(jax.random.PRNGKey(seed), jcfg))
    p["backbone"]["hash_table"] = (p["backbone"]["hash_table"] * 1e4).astype(np.float32)
    if "msg_tables" in p["trainable"]:
        p["trainable"]["msg_tables"] = (p["trainable"]["msg_tables"] * 1e3).astype(np.float32)
    jm.backbone = jax.tree_util.tree_map(jnp.asarray, p["backbone"])
    jm.trainable = jax.tree_util.tree_map(jnp.asarray, p["trainable"])
    tm.backbone, tm.trainable = port_params(p)
    occ = ball_occupancy(1.0, H=GRID)
    jm.occ = jm.occ._replace(occupancy=jnp.asarray(occ))
    tm.occ = tm.occ._replace(occupancy=torch.from_numpy(occ))
    return jm, tm


def whole_batch(seed=0, n_content=64):
    """A whole key image [1, 20, 20, 3] of one view of the ball (its
    watermark dict too), content rays of another, random pseudo-GT."""
    rays = view_rays(1.0, n=2, res=RES, seed=seed)
    ro = rays["rays_o"][0].reshape(1, RES, RES, 3)
    rd = rays["rays_d"][0].reshape(1, RES, RES, 3)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(RES * RES)[:n_content]
    ct_o, ct_d = rays["rays_o"][1][idx], rays["rays_d"][1][idx]
    gt = rng.uniform(size=(n_content, 3)).astype(np.float32)
    return {"rays_o": ro, "rays_d": rd}, ct_o, ct_d, gt


def wm_opt(**kw):
    d = dict(seed=0, iters=100, lr=1e-2, lambda_w=LAMBDA_W, lambda_i=LAMBDA_I, loss_w="bce",
             distortion="none", message_dim=D_BITS, devices=1, num_rays=64, max_ray_batch=4096,
             compact_frac=0, group_budget=0, bitacc_batch=4)
    d.update(kw)
    return types.SimpleNamespace(**d)


def _points(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _mlp(seed=0):
    p = j_crn.init_copyrnerf_mlp(jax.random.PRNGKey(seed), D_BITS)
    # larger outputs than the init's, so that tanh, the clip and the sigmoid
    # all matter
    p["layers"][-1]["w"] = p["layers"][-1]["w"] * 30.0
    return p, t_ckpt.conv_tree_from_jax(jax.tree_util.tree_map(np.asarray, p))


def test_freq_encode_matches_jax():
    x = np.random.default_rng(0).uniform(-1, 1, (128, 3)).astype(np.float32)
    for n in (4, 10):
        a = t_crn.freq_encode(T(x), n).numpy()
        b = np.asarray(j_crn.freq_encode(jnp.asarray(x), n))
        assert a.shape == b.shape == (128, 6 * n)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("replace", [False, True])
def test_copyrnerf_color_matches_jax(replace):
    pj, pt = _mlp()
    x, d = _points()
    rng = np.random.default_rng(1)
    x01 = (x + 1.0) / 2.0
    rgb = rng.uniform(size=(x.shape[0], 3)).astype(np.float32)
    raw = rng.normal(size=(x.shape[0],)).astype(np.float32) * 3
    msg = np.array([1, 0, 1, 1], np.int32)
    cj = np.asarray(j_crn.copyrnerf_color(pj, jnp.asarray(x01), jnp.asarray(d), jnp.asarray(rgb),
                                          jnp.asarray(raw), jnp.asarray(msg), replace=replace))
    ct = t_crn.copyrnerf_color(pt, T(x01), T(d), T(rgb), T(raw), T(msg), replace=replace)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-5)
    assert not np.allclose(cj, rgb, atol=1e-3)  # the message channel is live


def _jax_input(x, d, rgb, raw, msg, bound):
    """JAX's concatenated MLP input, as copyrnerf_color builds it from
    wtmk_field's x01."""
    x01 = (jnp.asarray(x) + bound) / (2.0 * bound)
    n = x.shape[0]
    m = jnp.broadcast_to((2.0 * jnp.asarray(msg).astype(jnp.float32) - 1.0)[None],
                         (n, msg.shape[0]))
    return np.asarray(jnp.concatenate(
        [j_crn.freq_encode(2.0 * x01 - 1.0, 10), j_crn.freq_encode(jnp.asarray(d), 4),
         jnp.asarray(rgb), jnp.asarray(raw)[:, None], m], axis=-1))


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_k10_plain_matches_jax_input(bound):
    x, d = _points(seed=2)
    x = x * bound
    rng = np.random.default_rng(3)
    rgb = rng.uniform(size=(x.shape[0], 3)).astype(np.float32)
    raw = (rng.normal(size=(x.shape[0],)) * 40).astype(np.float32)  # exp underflows below -87
    msg = np.array([0, 1, 1, 0, 1], np.int32)
    a = t_k10.copyrnerf_input(T(x), T(d), T(rgb), T(raw), T(msg), bound).numpy()
    b = _jax_input(x, d, rgb, raw, msg, bound)
    assert a.shape == (x.shape[0], 88 + 5) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert np.array_equal(a[:, 84:88], b[:, 84:88])  # rgb and raw copied as they are


def k10_plan(D):
    """csrc/copyrnerf.cu's plan: the rows a block stages (the most, up to
    64, whose floats and the message fit in 48 KB) and each angle q < 42 of
    a sample as (position?, channel, frequency, sine column, cosine
    column)."""
    W = 88 + D
    rows = min(64, (48 * 1024 // 4 - D) // W)
    angles = []
    for q in range(42):
        pos = q < 30
        c, k = divmod(q, 10) if pos else divmod(q - 30, 4)
        col = q if pos else 30 + q
        angles.append((pos, c, k, col, col + (30 if pos else 12)))
    return rows, angles


def k10_emulate(x, d, rgb, raw, msg, bound):
    """K10's kernel in numpy: each block's rows staged (an angle item a ->
    row a // 42, angle a % 42, its sine and cosine in their columns; rgb
    and raw at 84..87; the message broadcast), then stored as the span
    out[m0 W : (m0 + rows) W]."""
    M, D = x.shape[0], msg.shape[0]
    W = 88 + D
    rows_per_block, angles = k10_plan(D)
    out = np.full(M * W, np.nan, np.float32)
    f32 = np.float32
    for m0 in range(0, M, rows_per_block):
        rows = min(rows_per_block, M - m0)
        stage = np.full((rows, W), np.nan, np.float32)
        for a in range(rows * 42):
            r, q = divmod(a, 42)
            pos, c, k, col_s, col_c = angles[q]
            if pos:
                x01 = (x[m0 + r, c] + f32(bound)) / (f32(2.0) * f32(bound))
                p = f32(2.0) * x01 - f32(1.0)
            else:
                p = d[m0 + r, c]
            ang = p * (f32(np.pi) * f32(2.0 ** k))
            stage[r, col_s], stage[r, col_c] = np.sin(ang), np.cos(ang)
        stage[:, 84:87], stage[:, 87] = rgb[m0:m0 + rows], raw[m0:m0 + rows]
        stage[:, 88:] = np.where(msg != 0, f32(1.0), f32(-1.0))
        out[m0 * W:(m0 + rows) * W] = stage.reshape(-1)
    return out.reshape(M, W)


@pytest.mark.parametrize("D", [0, 3, 32, 1024])
def test_k10_column_map_matches_jax_layout(D):
    """K10's (sample, channel, frequency) -> column map and its staged rows
    against JAX's freq_encode order (sines channel-major, then cosines) and
    concatenation; every column written once; at every D a block stages at
    least one row within 48 KB."""
    rows, angles = k10_plan(D)
    assert 1 <= rows <= 64 and 4 * (rows * (88 + D) + D) <= 48 * 1024
    cols = sorted(c for a in angles for c in a[3:])
    assert cols == list(range(84))
    x, d = _points(seed=4)
    x = x[:70] * 2.0
    d = d[:70]
    rng = np.random.default_rng(5)
    rgb = rng.uniform(size=(70, 3)).astype(np.float32)
    raw = rng.normal(size=(70,)).astype(np.float32)
    msg = rng.integers(0, 2, D).astype(np.int32)
    a = k10_emulate(x, d, rgb, raw, msg, 2.0)
    b = _jax_input(x, d, rgb, raw, msg, 2.0)
    assert np.isfinite(a).all() and a.shape == b.shape
    np.testing.assert_allclose(a[:, :84], b[:, :84], rtol=0, atol=1e-5)
    assert np.array_equal(a[:, 84:], b[:, 84:])


def test_wtmk_field_copyrnerf_message_changes_rgb_not_sigma():
    jm, tm = make_mode_models(dict(copyrnerf=True))
    x, d = _points(64, seed=4)
    msg = np.array([1, 0, 1, 1], np.int32)
    fp_none = t_wm.wtmk_field_params(tm.backbone, tm.trainable, tm.wcfg, None)
    fp_msg = t_wm.wtmk_field_params(tm.backbone, tm.trainable, tm.wcfg, msg)
    s0, c0 = t_wm.wtmk_field(fp_none, tm.wcfg, T(x), T(d))
    s1, c1 = t_wm.wtmk_field(fp_msg, tm.wcfg, T(x), T(d))
    assert torch.equal(s0, s1) and (c1 - c0).abs().max() > 0
    flipped = msg.copy()
    flipped[0] = 0
    fp_flip = t_wm.wtmk_field_params(tm.backbone, tm.trainable, tm.wcfg, flipped)
    _, c2 = t_wm.wtmk_field(fp_flip, tm.wcfg, T(x), T(d))
    assert (c2 - c1).abs().max() > 0
    sj, cj = j_wm.wtmk_field(jm.backbone, jm.trainable, jm.wcfg, jnp.asarray(x), jnp.asarray(d),
                             jnp.asarray(msg))
    np.testing.assert_allclose(s1.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), np.asarray(cj), rtol=0, atol=1e-5)


def _leaf_pairs(tree_j, tree_t):
    """(name, port, jax) per leaf of two trainable trees (HWIO both)."""
    flat_j = jax.tree_util.tree_flatten_with_path(tree_j)[0]
    flat_t = jax.tree_util.tree_leaves(t_ckpt.trainable_to_jax(tree_t))
    assert len(flat_j) == len(flat_t)
    return [(jax.tree_util.keystr(k), np.asarray(b), np.asarray(a))
            for (k, a), b in zip(flat_j, flat_t)]


@pytest.mark.parametrize("replace", [False, True])
def test_copyrnerf_step_loss_and_grads_match_jax(monkeypatch, replace):
    jax_march_into_port(monkeypatch)
    jm, tm = make_mode_models(dict(copyrnerf=True, copyrnerf_replace=replace))
    wm, ct_o, ct_d, gt = whole_batch()
    ro_b, rd_b = t_twm.wm_rays(tm.wcfg, wm)
    message = np.array([1, 0, 1, 1], np.int32)

    def loss_j(tr):
        return j_twm._wm_step_loss(
            jm.backbone, tr, jm.occ.occupancy, *(jnp.asarray(v) for v in
                                                 (ro_b, rd_b, ct_o, ct_d, gt)),
            jnp.asarray(message), jax.random.PRNGKey(0), LAMBDA_W, LAMBDA_I, jm.wcfg, jm.rc,
            BUDGET, BUDGET, "none", j_twm.make_loss_w("bce"))

    (lj, (lwj, _, dj)), gj = jax.value_and_grad(loss_j, has_aux=True)(jm.trainable)
    for p in t_twm.trainable_leaves(tm.trainable):
        p.requires_grad_(True)
    lt, (lwt, _, dt) = t_twm._wm_step_loss(
        tm.backbone, tm.trainable, tm.occ.occupancy,
        *(T(np.ascontiguousarray(v)) for v in (ro_b, rd_b, ct_o, ct_d, gt)),
        T(message), None, LAMBDA_W, LAMBDA_I, tm.wcfg, tm.rc, BUDGET, BUDGET, "none",
        t_twm.make_loss_w("bce"))
    lt.backward()
    assert dt.shape == (1, D_BITS)  # all bits from the one whole image
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    np.testing.assert_allclose(dt.detach().numpy(), np.asarray(dj), rtol=1e-4, atol=1e-5)
    gt_ = t_twm._tree_map(lambda t: t.grad, tm.trainable)
    pairs = _leaf_pairs(gj, gt_)
    scale = max(np.linalg.norm(a) for _, _, a in pairs)
    assert any("msg_mlp" in n and np.linalg.norm(a) > 0 for n, _, a in pairs)
    for name, b, a in pairs:
        if np.linalg.norm(a) > 1e-5 * scale:
            assert rel_l2(b, a) <= 1e-4, (name, rel_l2(b, a))
        else:  # a conv bias before a batch norm
            assert np.linalg.norm(b) <= 1e-5 * scale, name


def test_copyrnerf_step_runs_no_table_and_no_backbone_backward():
    """The step builds no effective table, and nothing upstream of the
    colour MLP takes a gradient: the backbone leaves and the field's
    features stay out of autograd."""
    _, tm = make_mode_models(dict(copyrnerf=True))
    tt = t_twm.WatermarkTrainer("wm", wm_opt(), tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    fp = t_wm.wtmk_field_params(tm.backbone, tm.trainable, tm.wcfg, np.ones(D_BITS, np.int32))
    assert fp["msg_eff"] is None and fp["message"].dtype == torch.int32
    x, d = _points(32)
    feat = t_wm._encode_with_message(fp, tm.wcfg, T(x))
    assert not feat.requires_grad
    sigma, rgb = t_wm.wtmk_field(fp, tm.wcfg, T(x), T(d))
    assert not sigma.requires_grad and rgb.requires_grad
    assert all(p.requires_grad for p in tt.opt_leaves)
    assert len(tt.opt_leaves) == 6 + 38  # three MLP layers (b, w) + the decoder's leaves


# ---------------------------------------------------------------- device loop
WM_STEPS = 4
WM_RAYS = 32
P, H, W = 4, 16, 16


@pytest.fixture(scope="module")
def loop_runs():
    from test_torch_device_loop import _views

    jm, tm = make_mode_models(dict(copyrnerf=True))
    opt = wm_opt(distortion="noise", num_rays=WM_RAYS)
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    wm, *_ = whole_batch(seed=3)
    ro_b, rd_b = j_twm.wm_rays(jm.wcfg, wm)
    poses, images, intr = _views(3, seed=5)
    key = jax.random.PRNGKey(21)
    (jtr, jopt, lj, lwj, lij) = j_twm._wm_device_loop(
        jm.backbone, jm.trainable, jt.opt_state, jm.occ.occupancy, jnp.asarray(ro_b),
        jnp.asarray(rd_b), jnp.asarray(poses), jnp.asarray(images.reshape(P, -1, 3)),
        jnp.asarray(intr), key, jnp.float32(opt.lambda_w), jnp.float32(opt.lambda_i),
        jt.wcfg_train, jm.rc, jt.content_budget, jm.infer_budget, jt.optimizer.update,
        "noise", "bce", WM_STEPS, WM_RAYS, H, W)
    msg, pidx, pix, dist = [], [], [], []
    shape = t_twm.view_batch_shape(ro_b.shape)
    for k in jax.random.split(key, WM_STEPS):
        km, kp, ki, kd = jax.random.split(k, 4)
        msg.append(np.asarray(jax.random.randint(km, (D_BITS,), 0, 2)))
        pidx.append(int(jax.random.randint(kp, (), 0, P)))
        pix.append(np.asarray(jax.random.randint(ki, (WM_RAYS,), 0, H * W)))
        dist.append(np.asarray(jax.random.normal(kd, shape)))
    draws = t_dl.WmDraws(T(np.stack(msg).astype(np.int32)), torch.tensor(pidx),
                         T(np.stack(pix).astype(np.int64)), T(np.stack(dist)))
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    ro_t, rd_t = tt._device_rays(wm)
    lt, lwt, lit = t_dl.wm_device_loop(tt, data, ro_t, rd_t, WM_STEPS, draws=draws)
    return (np.asarray(lj), np.asarray(lwj), np.asarray(lij), jtr), (lt, lwt, lit, tm, tt)


def test_copyrnerf_loop_losses_match_jax(loop_runs):
    (lj, lwj, lij, _), (lt, lwt, lit, *_) = loop_runs
    for a, b in ((lt, lj), (lwt, lwj), (lit, lij)):
        np.testing.assert_allclose(a[:2], b[:2], rtol=1e-5)
        np.testing.assert_allclose(a, b, rtol=1e-3)


def test_copyrnerf_loop_trainable_matches_jax(loop_runs):
    (*_, jtr), (*_, tm, tt) = loop_runs
    _, tm0 = make_mode_models(dict(copyrnerf=True))
    start = jax.tree_util.tree_leaves(t_ckpt.trainable_to_jax(tm0.trainable))
    lr = wm_opt().lr
    pairs = _leaf_pairs(jtr, tm.trainable)
    assert tt.opt_count() == WM_STEPS
    for (name, a, b), a0 in zip(pairs, start):
        if "decoder" in name and name.endswith("['conv']['b']"):
            # a conv bias before a batch norm (every conv of the decoder)
            for v in (a, b):
                assert np.abs(v - a0).max() <= WM_STEPS * lr * (1 + 1e-3), name
        else:
            assert rel_l2(a, b) <= 1e-2, (name, rel_l2(a, b))


# ---------------------------------------------------------------- checkpoints
def _steps(trainer, n):
    wm, ct_o, ct_d, gt = whole_batch(seed=1)
    data = {"watermark": wm, "content": {"rays_o": ct_o, "rays_d": ct_d, "images": gt}}
    for _ in range(n):
        trainer.train_step_data(data, trainer.random_message())
        trainer.global_step += 1


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_copyrnerf_checkpoints_resume_across_packages(tmp_path, direction):
    jm, tm = make_mode_models(dict(copyrnerf=True))
    ws = str(tmp_path / "ws")
    opt = wm_opt()
    pkgs = (t_twm, j_twm) if direction == "port_to_jax" else (j_twm, t_twm)
    models = (tm, jm) if direction == "port_to_jax" else (jm, tm)
    writer = pkgs[0].WatermarkTrainer("ngp", opt, models[0], workspace=ws,
                                      use_checkpoint="scratch", mute=True)
    _steps(writer, 2)
    writer.epoch = 1
    writer.save_checkpoint(full=True)
    reader = pkgs[1].WatermarkTrainer("ngp", opt, models[1], workspace=ws,
                                      use_checkpoint="latest", mute=True)
    assert reader.global_step == 2 and reader._wm_state_loaded
    tt, jt = (writer, reader) if direction == "port_to_jax" else (reader, writer)
    assert tt.opt_count() == 2 and int(jt.opt_state[0].count) == 2
    for _, a, b in _leaf_pairs(jm.trainable, tm.trainable):
        assert np.array_equal(a, b)
    mu_t = t_twm._tree_map(lambda p: tt.optimizer.state[p]["exp_avg"], tm.trainable)
    for _, a, b in _leaf_pairs(jt.opt_state[0].mu, mu_t):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------- attacks
def test_copyrnerf_attack_suites(monkeypatch):
    """Under --copyrnerf the sweep decodes the whole key image and agrees
    with JAX's (the same messages, the same bit accuracy per deterministic
    attack); the parameter attack moves the colour MLP within epsilon and
    leaves the decoder bit-identical; the finetuning attack trains the
    backbone table through the MLP it holds frozen."""
    from nerf_signature_tpu.train import attack as j_atk
    from nerf_signature_tpu_torch.train import attack as t_atk

    jax_march_into_port(monkeypatch)
    jm, tm = make_mode_models(dict(copyrnerf=True))
    opt = wm_opt(bitacc_batch=4)
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    wm, ct_o, ct_d, gt = whole_batch(seed=4)
    names = ["none", "blur", "round"]
    rj = j_atk.attack_sweep(jt, [{"watermark": wm}], attacks=names, n_test=4)
    rt = t_atk.attack_sweep(tt, [{"watermark": wm}], attacks=names, n_test=4)
    assert list(rt) == names and rt == rj
    content = [{"content": {"rays_o": ct_o[None], "rays_d": ct_d[None], "images": gt[None]}}]
    tr0 = t_twm._tree_map(lambda t: t.detach().clone(), tm.trainable)
    attacked = t_atk.parameter_attack(tt, content, epsilon=1e-3, steps=2, lr=1e-2, num_rays=32)
    moved = [float((a - b).abs().max()) for a, b in zip(
        t_twm.trainable_leaves(attacked), t_twm.trainable_leaves(tr0))]
    n_mlp = 6  # the MLP's leaves come first
    assert max(moved[:n_mlp]) > 0 and max(moved) <= 1e-3 + 1e-6  # the clamp's fp32 rounding
    assert max(moved[n_mlp:]) == 0.0
    bb0 = tm.backbone["hash_table"].clone()
    out = t_atk.finetune_attack(tt, content, steps=2, lr=1e-2, num_rays=32)
    assert not torch.equal(out["hash_table"], bb0) and torch.equal(tm.backbone["hash_table"], bb0)
