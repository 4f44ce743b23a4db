"""Port parity of the whole-image watermark modes and ``--finetune_decoder``
against the JAX package (CPU: the plain versions of the kernels; the tiny
sizes of test_torch_copyrnerf).

  * ``wm_rays``: the strided whole key image (``ceil(max(H, W) / 96)``)
    equal to JAX's for ``--whole_image_wm`` and ``--copyrnerf`` at several
    image sizes; the key blocks otherwise.
  * ``--whole_image_wm`` (the codebook tables, all D bits from one image):
    the decoder's output is [1, D]; one whole step (loss, decoded logits,
    Adam's update) on JAX's samples: loss 1e-6 relative, logits 1e-4, and
    after Adam's first step (eps 1e-15, an update of -lr * sign(g)) the
    params within 1e-6 where |g| exceeds 1e-2 of the leaf's RMS gradient.
  * ``--finetune_decoder`` (3 key blocks of 4 x 4 rays, 3 bits): 3 steps
    on JAX's samples: the message tables
    bit-equal to their start in both packages (no gradient reaches them in
    the port; JAX zeroes their updates); the decoder leaves against JAX's
    ``multi_transform`` step within 1e-2 relative L2 (Adam's sign flips, as
    in test_torch_device_loop's watermark loop; a conv bias before a batch
    norm moving at most lr a step); the optimizer state written by either
    package in ``multi_transform``'s layout and read by the other (count and
    moments bit-equal).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.train import trainer_wtmk as j_twm
from nerf_signature_tpu_torch.models import hidden as t_hidden
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
from test_torch_copyrnerf import BUDGET, D_BITS, LAMBDA_I, LAMBDA_W, make_mode_models, \
    whole_batch, wm_opt
from test_torch_train_ops import rel_l2
from test_torch_wm_ops import wm_cfgs
from test_torch_wm_train import jax_march_into_port, wm_batch

T = torch.from_numpy


@pytest.mark.parametrize("H,W", [(20, 20), (96, 96), (97, 40), (200, 300), (801, 800)])
def test_wm_rays_match_jax(H, W):
    rng = np.random.default_rng(H * W)
    wm = {"rays_o": rng.normal(size=(1, H, W, 3)).astype(np.float32),
          "rays_d": rng.normal(size=(1, H, W, 3)).astype(np.float32),
          "rays_o_block": np.zeros((4, 2, 2, 3), np.float32),
          "rays_d_block": np.ones((4, 2, 2, 3), np.float32)}
    jcfg, tcfg = wm_cfgs()
    for mode in ({}, dict(whole_image=True), dict(copyrnerf=True)):
        jw, tw = dataclasses.replace(jcfg, **mode), dataclasses.replace(tcfg, **mode)
        (ro_j, rd_j), (ro_t, rd_t) = j_twm.wm_rays(jw, wm), t_twm.wm_rays(tw, wm)
        assert np.array_equal(ro_t, ro_j) and np.array_equal(rd_t, rd_j)
        if mode:
            assert max(ro_t.shape[1:3]) <= 96 and ro_t.shape[0] == 1
        else:
            assert ro_t.shape == (4, 2, 2, 3)


def _jax_step(jm, jt, batch, message):
    ro_b, rd_b, ct_o, ct_d, gt = (jnp.asarray(v) for v in batch)
    (jm.trainable, jt.opt_state, lj, _, _, dj) = j_twm._wtmk_train_step(
        jm.backbone, jm.trainable, jt.opt_state, jm.occ.occupancy, ro_b, rd_b, ct_o, ct_d, gt,
        jnp.asarray(message), jax.random.PRNGKey(0), jnp.float32(LAMBDA_W),
        jnp.float32(LAMBDA_I), jm.wcfg, jm.rc, BUDGET, BUDGET, jt.optimizer.update, "none",
        "bce")
    return float(lj), np.asarray(dj)


def _port_step(tm, tt, batch, message):
    lt, _, _, dt = tt._train_step(*(T(np.ascontiguousarray(v)) for v in batch),
                                  T(message), None, tm.rc)
    return float(lt), dt.numpy()


def _trainers(mode, message_dim=D_BITS):
    jm, tm = make_mode_models(mode, message_dim=message_dim)
    opt = wm_opt(message_dim=message_dim)
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    return jm, tm, jt, tt


def _whole_step_batch(tm, seed):
    wm, ct_o, ct_d, gt = whole_batch(seed=seed)
    return (*t_twm.wm_rays(tm.wcfg, wm), ct_o, ct_d, gt)


def test_whole_image_step_matches_jax(monkeypatch):
    jax_march_into_port(monkeypatch)
    jm, tm, jt, tt = _trainers(dict(whole_image=True))
    assert tm.wcfg.decoder.num_bits == D_BITS
    batch = _whole_step_batch(tm, 2)
    message = np.array([1, 0, 0, 1], np.int32)
    w0 = jax.tree_util.tree_map(np.asarray, jm.trainable)

    def loss_j(tr):
        ro_b, rd_b, ct_o, ct_d, gt = (jnp.asarray(v) for v in batch)
        return j_twm._wm_step_loss(
            jm.backbone, tr, jm.occ.occupancy, ro_b, rd_b, ct_o, ct_d, gt,
            jnp.asarray(message), jax.random.PRNGKey(0), LAMBDA_W, LAMBDA_I, jm.wcfg, jm.rc,
            BUDGET, BUDGET, "none", j_twm.make_loss_w("bce"))[0]

    gj = jax.grad(loss_j)(jm.trainable)
    lj, dj = _jax_step(jm, jt, batch, message)
    lt, dt = _port_step(tm, tt, batch, message)
    assert dt.shape == dj.shape == (1, D_BITS)
    assert abs(lt - lj) <= 1e-6 * abs(lj)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-5)
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
        np.testing.assert_allclose(pt[sure], (w - 1e-2 * np.sign(g))[sure], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def finetune_runs():
    mp = pytest.MonkeyPatch()
    jax_march_into_port(mp)
    try:
        # the key blocks of test_torch_wm_train: 3 blocks, 3 bits
        jm, tm, jt, tt = _trainers(dict(finetune_decoder=True), message_dim=3)
        start = t_twm._tree_map(lambda t: t.detach().clone(), tm.trainable)
        rng = np.random.default_rng(0)
        for step in range(3):
            batch = wm_batch(seed=step)
            message = rng.integers(0, 2, 3).astype(np.int32)
            _jax_step(jm, jt, batch, message)
            _port_step(tm, tt, batch, message)
    finally:
        mp.undo()
    return jm, tm, jt, tt, start


def test_finetune_decoder_keeps_the_tables_bit_equal(finetune_runs):
    jm, tm, jt, tt, start = finetune_runs
    assert torch.equal(tm.trainable["msg_tables"], start["msg_tables"])
    assert np.array_equal(np.asarray(jm.trainable["msg_tables"]),
                          start["msg_tables"].numpy())
    assert tm.trainable["msg_tables"].grad is None and not tm.trainable["msg_tables"].requires_grad
    assert tt.opt_count() == 3
    assert int(jt.opt_state.inner_states["train"].inner_state[0].count) == 3


def test_finetune_decoder_leaves_match_jax_multi_transform(finetune_runs):
    jm, tm, jt, tt, start = finetune_runs
    tl = t_hidden.decoder_leaves(tm.trainable["decoder"])
    sl = t_hidden.decoder_leaves(start["decoder"])
    jl = [np.asarray(v) for v in jax.tree_util.tree_leaves(jm.trainable["decoder"])]
    assert len(tl) == len(jl) == len(sl)
    moved = 0
    for i, (a, b, a0) in enumerate(zip(tl, jl, sl)):
        a, a0 = a.detach().numpy(), a0.numpy()
        if b.ndim == 4:  # conv kernels: JAX HWIO, the port OIHW
            b = b.transpose(3, 2, 0, 1)
        moved += int(not np.array_equal(a, a0))
        if i % 4 == 2 and i < len(tl) - 2:  # a conv bias before a batch norm
            for x in (a, b):
                assert np.abs(x - a0).max() <= 3 * 1e-2 * (1 + 1e-3)
        else:
            assert rel_l2(a, b) <= 1e-2, i
    assert moved == len(tl)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_finetune_decoder_opt_state_loads_both_ways(tmp_path, direction):
    jm, tm = make_mode_models(dict(finetune_decoder=True), message_dim=3)
    ws = str(tmp_path / "ws")
    opt = wm_opt(message_dim=3)
    port_writes = direction == "port_to_jax"
    pkgs = (t_twm, j_twm) if port_writes else (j_twm, t_twm)
    writer = pkgs[0].WatermarkTrainer("ngp", opt, tm if port_writes else jm, workspace=ws,
                                      use_checkpoint="scratch", mute=True)
    batch = wm_batch(seed=1)
    data = {"watermark": {"rays_o_block": batch[0], "rays_d_block": batch[1]},
            "content": {"rays_o": batch[2], "rays_d": batch[3], "images": batch[4]}}
    for _ in range(2):
        writer.train_step_data(data, writer.random_message())
        writer.global_step += 1
    writer.epoch = 1
    path = writer.save_checkpoint(full=True)
    raw = t_ckpt.load_checkpoint(path)["opt_state"]
    assert set(raw["inner_states"]) == {"train", "freeze"}
    mu = raw["inner_states"]["train"]["inner_state"]["0"]["mu"]
    assert mu["msg_tables"] == {} and set(mu["decoder"]) == {"blocks", "head", "linear"}
    reader = pkgs[1].WatermarkTrainer("ngp", opt, jm if port_writes else tm, workspace=ws,
                                      use_checkpoint="latest", mute=True)
    tt, jt = (writer, reader) if port_writes else (reader, writer)
    assert tt.opt_count() == 2
    assert int(jt.opt_state.inner_states["train"].inner_state[0].count) == 2
    mu_j = jt.opt_state.inner_states["train"].inner_state[0].mu["decoder"]
    mu_t = t_ckpt.conv_tree_to_jax(t_twm._tree_map(
        lambda p: tt.optimizer.state[p]["exp_avg"], tm.trainable["decoder"]))
    for a, b in zip(jax.tree_util.tree_leaves(mu_t), jax.tree_util.tree_leaves(mu_j)):
        assert np.array_equal(a, np.asarray(b))
    for p in t_hidden.decoder_leaves(tm.trainable["decoder"]):
        assert np.array_equal(tt.optimizer.state[p]["exp_avg_sq"].numpy().shape, p.shape)
    assert not any(p in tt.optimizer.state for p in [tm.trainable["msg_tables"]])


@pytest.mark.parametrize("flags", [["--copyrnerf"], ["--copyrnerf", "--copyrnerf_replace"],
                                   ["--whole_image_wm"], ["--finetune_decoder"]])
def test_wm_cli_trains_and_verifies_each_baseline(tmp_path, flags):
    """``main_nerf_wtmk --cpu`` with each baseline's flags trains (2 steps
    per step, 2 through the device loop) and then ``--test`` verifies
    ownership; the checkpoint holds the mode's trainable tree (JAX's
    keys)."""
    from nerf_signature_tpu.train import checkpoint as j_ckpt
    from nerf_signature_tpu_torch import main_nerf_wtmk as t_main
    from test_torch_device_loop import _clean_ckpt
    from test_torch_wm_io import _cli_flags, write_scene

    scene = write_scene(str(tmp_path / "scene"))
    ws = str(tmp_path / "ws")
    base = _cli_flags(scene, ws, _clean_ckpt(tmp_path), iters=2) + flags
    assert t_main.main(base) == 0
    assert t_main.main(base[:-len(flags)] + ["--steps_per_dispatch", "2", "--iters", "4"]
                       + flags) == 0
    assert t_main.main(base + ["--ckpt", "latest", "--test", "--n_test_bitacc", "2"]) == 0
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "[wm device loop]" in log and "[test_bitacc]" in log
    raw = j_ckpt.load_checkpoint(t_ckpt.latest_checkpoint(os.path.join(ws, "checkpoints"),
                                                          "ngp"))
    assert int(raw["global_step"]) == 4
    assert ("msg_mlp" in raw["trainable"]) == ("--copyrnerf" in flags)
    head = raw["trainable"]["decoder"]["head"]["conv"]["w"]
    whole = "--finetune_decoder" not in flags
    assert head.shape[-1] == (3 if whole else 1)  # D bits from one image, or 1 a block
    if not whole:
        assert set(raw["opt_state"]) == {"inner_states"}
