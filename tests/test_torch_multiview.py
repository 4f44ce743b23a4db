"""Multi-view key blocks (``--n_views V > 1``) in the port against the JAX
package: the provider's V key poses, block coordinates, ray bundles and key
renders; ``_per_view`` and the multi-view block render; the V = 2 watermark
step's loss and gradients (on the same samples, with per-view noise drawn
at JAX's shape); the V = 2 decoder through a checkpoint; and the port's CLI
training with ``--n_views 2 --distortion jpeg`` then running every attack
flag in ``--test``.

Tolerances: poses, coordinates and rays exactly equal (the same numpy
code); key renders atol 1e-4 (test_torch_wm_io's); the step on the same
samples as test_torch_wm_train's fp32 step: loss 1e-6 relative, message
tables 1e-5 and decoder leaves 1e-4 relative L2.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.data import provider_wtmk as j_prov
from nerf_signature_tpu.train import trainer_wtmk as j_twm
from nerf_signature_tpu_torch import api as t_api
from nerf_signature_tpu_torch.data import provider_wtmk as t_prov
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
from test_torch_render import ball_occupancy, view_rays
from test_torch_wm_io import RES, _cli_flags, _popt, write_scene
from test_torch_wm_ops import port_params, wm_cfgs, wm_params
from test_torch_wm_train import (BUDGET, GRID, check_grads, jax_march_into_port,
                                 make_wm_models)

T = torch.from_numpy
V = 2


def make_views_models(dtype="fp32"):
    """The tiny watermark models of test_torch_wm_train with a two-view
    decoder (input_ch 6)."""
    jcfg, tcfg = (dataclasses.replace(c, n_views=V) for c in wm_cfgs(dtype))
    kw = dict(density_thresh=0.01, max_steps=64, grid_size=GRID, train_budget=BUDGET,
              infer_budget=BUDGET)
    from nerf_signature_tpu import api as j_api

    jm = j_api.WatermarkModel(jcfg, **kw)
    tm = t_api.WatermarkModel(tcfg, device="cpu", **kw)
    p = wm_params(jcfg)
    jm.backbone = jax.tree_util.tree_map(jnp.asarray, p["backbone"])
    jm.trainable = jax.tree_util.tree_map(jnp.asarray, p["trainable"])
    tm.backbone, tm.trainable = port_params(p)
    occ = ball_occupancy(1.0, H=GRID)
    jm.occ = jm.occ._replace(occupancy=jnp.asarray(occ))
    tm.occ = tm.occ._replace(occupancy=T(occ))
    return jm, tm


def views_batch(seed=0, n_content=64, block=4):
    """Key-block bundles [3, V, 4, 4, 3]: the same three blocks cut from two
    views of the ball; content rays of a third view, random pseudo-GT."""
    rays = view_rays(1.0, n=V + 1, res=20, seed=seed)
    ro = rays["rays_o"].reshape(V + 1, 20, 20, 3)
    rd = rays["rays_d"].reshape(V + 1, 20, 20, 3)
    corners = [(4, 4), (8, 10), (12, 6)]
    ro_b = np.stack([ro[:V, r:r + block, c:c + block] for r, c in corners])
    rd_b = np.stack([rd[:V, r:r + block, c:c + block] for r, c in corners])
    rng = np.random.default_rng(seed)
    idx = rng.permutation(400)[:n_content]
    gt = rng.uniform(size=(n_content, 3)).astype(np.float32)
    return ro_b, rd_b, ro[V].reshape(-1, 3)[idx], rd[V].reshape(-1, 3)[idx], gt


def _provider(pkg, model, opt, ws, type="train", fresh=False):
    kp, kb = os.path.join(ws, "key_poses.npy"), os.path.join(ws, "key_blocks.npy")
    return pkg.NeRFDatasetDisen(
        opt, keyposes_dir=None if fresh else kp, keyposes_save_dir=kp if fresh else None,
        keyblocks_dir=None if fresh else kb, keyblocks_save_dir=kb if fresh else None,
        pretrained_model=model, type=type, n_views=V, n_test=3, message_dim=3, num_rows=4,
        num_cols=4)


@pytest.mark.parametrize("use_existset", [False, True])
def test_two_view_provider_matches_jax(tmp_path, use_existset):
    root = write_scene(str(tmp_path / "scene"))
    jm, tm = make_wm_models("fp32")
    ws_j, ws_t = str(tmp_path / "ws_j"), str(tmp_path / "ws_t")
    os.makedirs(ws_j), os.makedirs(ws_t)
    opt = _popt(root, use_existset=use_existset)
    kw = dict(use_existset=use_existset)
    pj = j_prov.NeRFDatasetDisen(opt, None, os.path.join(ws_j, "key_poses.npy"), None,
                                 os.path.join(ws_j, "key_blocks.npy"), jm, type="train",
                                 n_views=V, n_test=3, message_dim=3, num_rows=4, num_cols=4,
                                 **kw)
    pt = t_prov.NeRFDatasetDisen(opt, None, os.path.join(ws_t, "key_poses.npy"), None,
                                 os.path.join(ws_t, "key_blocks.npy"), tm, type="train",
                                 n_views=V, n_test=3, message_dim=3, num_rows=4, num_cols=4,
                                 **kw)
    assert pt.watermark_poses.shape == (V, 4, 4)
    for name in ("key_poses.npy", "key_blocks.npy"):
        assert np.array_equal(np.load(os.path.join(ws_j, name)), np.load(os.path.join(ws_t, name)))
    assert np.array_equal(pt.block_coordinates, np.asarray(pj.block_coordinates))
    for k in ("rays_o_block", "rays_d_block"):
        assert getattr(pt, k).shape == (3, V, RES // 4, RES // 4, 3)
        assert np.array_equal(getattr(pt, k), np.asarray(getattr(pj, k)))
    for k in ("images_block_views", "images_block", "watermark_images_views"):
        np.testing.assert_allclose(getattr(pt, k), np.asarray(getattr(pj, k)), atol=1e-4)
    if use_existset:  # V copies of the first train pose
        assert np.array_equal(pt.watermark_poses[0], pt.watermark_poses[1])
    else:
        assert not np.array_equal(pt.watermark_poses[0], pt.watermark_poses[1])
    # a key-poses file of V rows sets V; the test split reads the written keys
    qt = _provider(t_prov, tm, opt, ws_t, type="test")
    assert qt.watermark_poses.shape == (V, 4, 4)
    assert np.array_equal(qt.rays_o_block, pt.rays_o_block)
    bj, bt = next(iter(pj)), next(iter(pt))
    for k in ("rays_o_block", "rays_d_block"):
        assert np.array_equal(bt["watermark"][k], np.asarray(bj["watermark"][k]))
    for k in ("rays_o", "rays_d"):
        assert np.array_equal(bt["content"][k], bj["content"][k])


def test_per_view_and_multi_view_render_shapes():
    rng = np.random.default_rng(1)
    blocks = rng.uniform(size=(3, 4, 5, 3 * V)).astype(np.float32)
    f = np.linspace(0.5, 1.5, 3 * V, dtype=np.float32).reshape(3 * V, 1, 1, 1)
    fn_j = lambda x: x * jnp.asarray(f) + jnp.arange(3.0)
    fn_t = lambda x: x * T(f) + torch.arange(3.0)
    yj = np.asarray(j_twm._per_view(fn_j, jnp.asarray(blocks)))
    yt = t_twm._per_view(fn_t, T(blocks)).numpy()
    assert yt.shape == blocks.shape and np.array_equal(yt, yj)
    # view v of block d is batch entry d*V + v, channels 3v..3v+2
    np.testing.assert_allclose(yt[1, ..., 3:6], blocks[1, ..., 3:6] * f[1 * V + 1] + [0, 1, 2],
                               rtol=1e-6)
    assert np.array_equal(t_twm._per_view(lambda x: x, T(blocks[..., :3])).numpy(),
                          blocks[..., :3])
    assert t_twm.view_batch_shape((3, V, 4, 5, 3)) == (3 * V, 4, 5, 3)
    assert t_twm.view_batch_shape((3, 4, 5, 3)) == (3, 4, 5, 3)
    _, tm = make_views_models()
    ro_b, rd_b, *_ = views_batch()
    fp = t_twm.wtmk_field_params(tm.backbone, tm.trainable, tm.wcfg, torch.tensor([1, 0, 1]))
    with torch.no_grad():
        b2 = t_twm._render_blocks(fp, tm.occ.occupancy, T(ro_b), T(rd_b), tm.wcfg, tm.rc, BUDGET)
        b1 = t_twm._render_blocks(fp, tm.occ.occupancy, T(ro_b[:, 1]), T(rd_b[:, 1]), tm.wcfg,
                                  tm.rc, BUDGET)
    assert b2.shape == (3, 4, 4, 3 * V) and b1.shape == (3, 4, 4, 3)
    np.testing.assert_allclose(b2[..., 3:].numpy(), b1.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("distortion", ["none", "noise"])
def test_two_view_step_loss_and_grads_match_jax(monkeypatch, distortion):
    jax_march_into_port(monkeypatch)
    jm, tm = make_views_models()
    batch = views_batch(seed=2)
    message = np.array([0, 1, 1], np.int32)
    key = jax.random.PRNGKey(4)
    ro_b, rd_b, ct_o, ct_d, gt = (jnp.asarray(v) for v in batch)

    def loss_fn(tr):
        return j_twm._wm_step_loss(
            jm.backbone, tr, jm.occ.occupancy, ro_b, rd_b, ct_o, ct_d, gt,
            jnp.asarray(message), key, 0.5, 1.0, jm.wcfg, jm.rc, BUDGET, BUDGET, distortion,
            j_twm.make_loss_w("bce"))

    (lj, (_, _, dj)), gj = jax.value_and_grad(loss_fn, has_aux=True)(jm.trainable)
    shape = t_twm.view_batch_shape(batch[0].shape)
    draws = None if distortion == "none" else T(np.asarray(jax.random.normal(key, shape)))
    for p in t_twm.trainable_leaves(tm.trainable):
        p.grad = None
        p.requires_grad_(True)
    lt, (_, _, dt) = t_twm._wm_step_loss(
        tm.backbone, tm.trainable, tm.occ.occupancy, *(T(np.ascontiguousarray(v)) for v in batch),
        torch.as_tensor(message), draws, 0.5, 1.0, tm.wcfg, tm.rc, BUDGET, BUDGET, distortion,
        t_twm.make_loss_w("bce"))
    lt.backward()
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    assert dt.shape == (3, 1)
    np.testing.assert_allclose(dt.detach().numpy(), np.asarray(dj), rtol=1e-4, atol=1e-5)
    grads = t_twm._tree_map(lambda t: t.grad, tm.trainable)
    check_grads(gj, grads, 1e-5, 1e-4)


def test_two_view_decoder_through_a_checkpoint():
    jm, tm = make_views_models()
    assert tm.wcfg.decoder.input_ch == 6
    back = t_ckpt.trainable_from_jax(t_ckpt.trainable_to_jax(tm.trainable))
    for a, b in zip(t_twm.trainable_leaves(back), t_twm.trainable_leaves(tm.trainable)):
        assert torch.equal(a, b)
    shapes_j = [np.shape(x) for x in jax.tree_util.tree_leaves(jm.trainable)]
    shapes_t = [np.shape(x) for x in jax.tree_util.tree_leaves(
        t_ckpt.trainable_to_jax(tm.trainable))]
    assert shapes_t == shapes_j


@pytest.mark.parametrize("full", [False, True], ids=["hash_table", "full_backbone"])
def test_cli_trains_two_views_with_jpeg_and_runs_every_attack(tmp_path, full):
    """``--n_views 2 --distortion jpeg`` trains through the port's CLI, and
    ``--test`` runs the sweep and both parameter-space attacks; the
    original weights are back afterwards."""
    from nerf_signature_tpu_torch import main_nerf_wtmk as t_main
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig

    scene = write_scene(str(tmp_path / "scene"))
    clean = NGPModel(NGPConfig(bound=1.0, n_levels=2, compute_dtype=torch.float32),
                     grid_size=16, device="cpu", seed=3)
    clean.params["hash_table"].mul_(1e4)
    clean.occ = clean.occ._replace(occupancy=T(ball_occupancy(1.0, H=16)))
    ckpt = str(tmp_path / "clean" / "ngp_ep0001.ckpt")
    t_ckpt.save_checkpoint(ckpt, {"params": clean.params, "occ": clean.occ})
    ws = str(tmp_path / "ws")
    flags = _cli_flags(scene, ws, ckpt, iters=2) + ["--n_views", "2", "--distortion", "jpeg"]
    assert t_main.main(flags) == 0
    assert np.load(os.path.join(ws, "key_poses.npy")).shape == (2, 4, 4)
    test = [f if f != ckpt else "latest" for f in flags] + [
        "--test", "--attack_suite", "--n_test_attack", "2", "--adv_attack", "--adv_steps", "2",
        "--finetune_attack", "--finetune_attack_steps", "2"]
    if full:
        test.append("--finetune_attack_full")
    assert t_main.main(test) == 0
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert log.count("[attack_sweep]") >= 13 and "[parameter_attack]" in log
    assert f"full_backbone={full}" in log and "AFTER backbone finetuning attack" in log
    assert os.path.isdir(os.path.join(ws, "test_image_after_finetune_attack"))
