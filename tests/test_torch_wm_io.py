"""The watermark stage's data and files across the two packages: the
provider's key material and block bundles from the same key files,
watermark checkpoints written by one package and resumed by the other (with
the crash-resume guard), and both CLIs on a tiny ball scene, each reading
the other's workspace in ``--test``.

The scene is a Blender-style ``transforms_{train,test}.json`` with ``h``/``w``
and no images (the watermark stage renders its own ground truth), 16x16
views of right-handed orbit poses.  Models are the tiny ones of
test_torch_wm_ops (fp32).

Tolerances: rays and block coordinates exactly equal (the same numpy
code); rendered key blocks and pseudo-GT atol 1e-4 (the renderers' fp32
sums in another order, ROADMAP queue 3's FMA ulps); decoded logits after a
checkpoint crosses packages rtol 1e-4 / atol 1e-5 (the same params, the
same samples up to those ulps).
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from nerf_signature_tpu.data import provider_wtmk as j_prov
from nerf_signature_tpu.train import trainer_wtmk as j_twm
from nerf_signature_tpu_torch.data import provider_wtmk as t_prov
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
from test_torch_wm_train import _opt, make_wm_models, wm_batch

T = torch.from_numpy
RES = 16
ANGLE = 0.8


def orbit_poses_rh(rng, n, radius=1.8):
    """Right-handed orbit poses (scipy's slerp of test poses needs det > 0)."""
    th = rng.uniform(np.pi / 3, 2 * np.pi / 3, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    c = np.stack([radius * np.sin(th) * np.sin(ph), radius * np.cos(th),
                  radius * np.sin(th) * np.cos(ph)], -1).astype(np.float32)
    fwd = -c / np.linalg.norm(c, axis=-1, keepdims=True)
    right = np.cross(np.tile([0.0, -1.0, 0.0], (n, 1)), fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    up = np.cross(fwd, right)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, fwd], -1)
    poses[:, :3, 3] = c
    return poses


def write_scene(root, n_train=4, n_test=2, seed=0):
    """transforms_{train,test}.json (h, w, camera_angle_x; no images)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        frames = []
        for i, p in enumerate(orbit_poses_rh(rng, n)):
            m = np.eye(4, dtype=np.float32)  # inverse of nerf_matrix_to_ngp at scale 1
            m[0] = [p[2, 0], -p[2, 1], -p[2, 2], p[2, 3]]
            m[1] = [p[0, 0], -p[0, 1], -p[0, 2], p[0, 3]]
            m[2] = [p[1, 0], -p[1, 1], -p[1, 2], p[1, 3]]
            frames.append({"file_path": f"r_{i}", "transform_matrix": m.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": ANGLE, "h": RES, "w": RES, "frames": frames}, f)
    return root


def _popt(root, **kw):
    d = dict(path=root, scale=1.0, offset=[0, 0, 0], bound=1.0, num_rays=32, seed=0,
             patch_size=1, pseudo_gt_cache=None, block_selection="random", max_ray_batch=4096)
    d.update(kw)
    return types.SimpleNamespace(**d)


def _provider(pkg, model, opt, ws, type="train", fresh=False):
    kp, kb = os.path.join(ws, "key_poses.npy"), os.path.join(ws, "key_blocks.npy")
    return pkg.NeRFDatasetDisen(
        opt, keyposes_dir=None if fresh else kp, keyposes_save_dir=kp if fresh else None,
        keyblocks_dir=None if fresh else kb, keyblocks_save_dir=kb if fresh else None,
        pretrained_model=model, type=type, n_views=1, n_test=3, message_dim=3, num_rows=4,
        num_cols=4)


def test_provider_key_material_and_block_bundles_match_jax(tmp_path):
    root = write_scene(str(tmp_path / "scene"))
    jm, tm = make_wm_models("fp32")
    ws_j, ws_t = str(tmp_path / "ws_j"), str(tmp_path / "ws_t")
    os.makedirs(ws_j), os.makedirs(ws_t)
    opt = _popt(root)
    pj = _provider(j_prov, jm, opt, ws_j, fresh=True)
    pt = _provider(t_prov, tm, opt, ws_t, fresh=True)
    # the same generator draws the same key pose and blocks
    for name in ("key_poses.npy", "key_blocks.npy"):
        assert np.array_equal(np.load(os.path.join(ws_j, name)), np.load(os.path.join(ws_t, name)))
    assert pt.images_block.shape == (3, RES // 4, RES // 4, 3)
    for k in ("rays_o_block", "rays_d_block"):
        assert np.array_equal(getattr(pt, k), np.asarray(getattr(pj, k)))
    np.testing.assert_allclose(pt.images_block, np.asarray(pj.images_block), atol=1e-4)
    np.testing.assert_allclose(pt.train_images, np.asarray(pj.train_images), atol=1e-4)
    assert pt.images_block.std() > 1e-3  # the key blocks see the ball
    # a train batch: the same content rays and pseudo-GT pixels
    bj, bt = next(iter(pj)), next(iter(pt))
    for k in ("rays_o", "rays_d"):
        assert np.array_equal(bt["content"][k], bj["content"][k])
    np.testing.assert_allclose(bt["content"]["images"], bj["content"]["images"], atol=1e-4)
    # the test split reads the JAX-written key files
    qt = _provider(t_prov, tm, opt, ws_j, type="test")
    assert np.array_equal(qt.block_coordinates, np.load(os.path.join(ws_j, "key_blocks.npy")))
    assert np.array_equal(qt.rays_o_block, np.asarray(pj.rays_o_block))
    assert len(qt) == 3 and list(next(iter(qt))) == ["watermark"]
    for ptype in ("test_image", "test_image_testviews"):
        it = _provider(t_prov, tm, opt, ws_j, type=ptype)
        ij = _provider(j_prov, jm, opt, ws_j, type=ptype)
        np.testing.assert_allclose(it.content_images, np.asarray(ij.content_images), atol=1e-4)
    # two key views drawn afresh, the JAX-written blocks cut from both renders
    p2 = t_prov.NeRFDatasetDisen(opt, None, None, os.path.join(ws_j, "key_blocks.npy"), None,
                                 tm, type="train", n_views=2, message_dim=3, num_rows=4,
                                 num_cols=4)
    assert p2.watermark_poses.shape == (2, 4, 4)
    assert p2.rays_o_block.shape == (3, 2, RES // 4, RES // 4, 3)
    assert p2.images_block_views.shape == (3, 2, RES // 4, RES // 4, 3)
    assert np.array_equal(p2.images_block, p2.images_block_views[:, 0])


def test_pseudo_gt_cache_round_trip(tmp_path, capsys):
    root = write_scene(str(tmp_path / "scene"))
    _, tm = make_wm_models("fp32")
    cache = str(tmp_path / "pgt.npz")
    opt = _popt(root, pseudo_gt_cache=cache)
    first = _provider(t_prov, tm, opt, str(tmp_path), fresh=True).train_images
    assert "saved cache" in capsys.readouterr().out
    os.remove(tmp_path / "key_poses.npy"), os.remove(tmp_path / "key_blocks.npy")
    again = _provider(t_prov, tm, opt, str(tmp_path), fresh=True).train_images
    assert "loaded cache" in capsys.readouterr().out and np.array_equal(first, again)


def _steps(trainer, pkg, n, seed=0):
    ro_b, rd_b, ct_o, ct_d, gt = wm_batch(seed=seed)
    data = {"watermark": {"rays_o_block": ro_b, "rays_d_block": rd_b},
            "content": {"rays_o": ct_o, "rays_d": ct_d, "images": gt}}
    for _ in range(n):
        trainer.train_step_data(data, trainer.random_message())
        trainer.global_step += 1


def _decoded(trainer, messages):
    ro_b, rd_b, *_ = wm_batch()
    wm = {"rays_o_block": ro_b, "rays_d_block": rd_b}
    return np.stack([np.asarray(trainer.eval_blocks(wm, m, "none")[1]) for m in messages])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_watermark_checkpoints_resume_across_packages(tmp_path, direction):
    """Two steps in one package, a full checkpoint, then the other package
    resumes it: the same trainable params, Adam state and decoded logits."""
    jm, tm = make_wm_models("fp32")
    ws = str(tmp_path / "ws")
    opt = _opt()
    if direction == "port_to_jax":
        writer = t_twm.WatermarkTrainer("ngp", opt, tm, workspace=ws, use_checkpoint="scratch",
                                        mute=True)
        _steps(writer, t_twm, 2)
        writer.epoch = 1
        writer.save_checkpoint(full=True)
        reader = j_twm.WatermarkTrainer("ngp", opt, jm, workspace=ws, use_checkpoint="latest",
                                        mute=True)
        assert int(reader.opt_state[0].count) == 2 and reader.global_step == 2
    else:
        writer = j_twm.WatermarkTrainer("ngp", opt, jm, workspace=ws, use_checkpoint="scratch",
                                        mute=True)
        _steps(writer, j_twm, 2)
        writer.epoch = 1
        writer.save_checkpoint(full=True)
        reader = t_twm.WatermarkTrainer("ngp", opt, tm, workspace=ws, use_checkpoint="latest",
                                        mute=True)
        assert reader.opt_count() == 2 and reader.global_step == 2
    assert reader._wm_state_loaded
    port_tr = t_ckpt.trainable_to_jax(tm.trainable)
    for a, b in zip(jax.tree_util.tree_leaves(port_tr), jax.tree_util.tree_leaves(jm.trainable)):
        assert np.array_equal(a, np.asarray(b))
    tt = reader if direction == "jax_to_port" else writer
    jt = reader if direction == "port_to_jax" else writer
    mu_t = t_ckpt.trainable_to_jax(t_twm._tree_map(
        lambda p: tt.optimizer.state[p]["exp_avg"], tm.trainable))
    for a, b in zip(jax.tree_util.tree_leaves(mu_t),
                    jax.tree_util.tree_leaves(jt.opt_state[0].mu)):
        assert np.array_equal(a, np.asarray(b))
    messages = [np.array(m, np.int32) for m in ([1, 0, 1], [0, 1, 1], [0, 0, 0])]
    np.testing.assert_allclose(_decoded(tt, messages), _decoded(jt, messages), rtol=1e-4,
                               atol=1e-5)


def _clean_checkpoint(path, tm):
    t_ckpt.save_checkpoint(path, {"params": tm.backbone, "occ": tm.occ, "epoch": 12,
                                  "global_step": 120})


def test_resume_guard_prefers_workspace_progress_over_the_clean_ckpt(tmp_path):
    _, tm = make_wm_models("fp32")
    clean = str(tmp_path / "clean" / "ngp_ep0012.ckpt")
    _clean_checkpoint(clean, tm)
    ws = str(tmp_path / "ws")
    opt = _opt()
    tr = t_twm.WatermarkTrainer("ngp", opt, tm, workspace=ws, use_checkpoint=clean, mute=True)
    assert tr.global_step == 0 and not tr._wm_state_loaded
    _steps(tr, t_twm, 3)
    tr.epoch = 1
    tr.save_checkpoint(full=True)
    # a stale clean-format checkpoint in the ring is not a resume candidate
    _clean_checkpoint(os.path.join(ws, "checkpoints", "ngp_ep0000.ckpt"), tm)
    _, tm2 = make_wm_models("fp32", seed=1)
    again = t_twm.WatermarkTrainer("ngp", opt, tm2, workspace=ws, use_checkpoint=clean,
                                   mute=True)
    assert again.global_step == 3 and again.opt_count() == 3 and again._wm_state_loaded
    assert torch.equal(tm2.trainable["msg_tables"], tm.trainable["msg_tables"])
    # an explicit path inside the workspace is a deliberate rewind: model only
    _, tm3 = make_wm_models("fp32", seed=1)
    inside = os.path.join(ws, "checkpoints", "ngp_ep0001.ckpt")
    rewind = t_twm.WatermarkTrainer("ngp", opt, tm3, workspace=ws, use_checkpoint=inside,
                                    mute=True)
    assert rewind.global_step == 0 and rewind._wm_state_loaded


def test_watermark_trainer_starts_from_a_jax_clean_checkpoint(tmp_path):
    """A clean checkpoint the JAX package's Trainer wrote (params, EMA,
    grid, optax state) becomes the frozen backbone and grid; the message
    tables and the decoder keep their init."""
    import types as _types

    import jax.numpy as jnp

    from nerf_signature_tpu.api import NGPModel as JModel
    from nerf_signature_tpu.train import trainer as j_trainer
    from test_torch_render import ball_occupancy
    from test_torch_wm_ops import wm_cfgs

    jm = JModel(wm_cfgs()[0].ngp, density_thresh=0.01, max_steps=64, grid_size=16)
    jm.occ = jm.occ._replace(occupancy=jnp.asarray(ball_occupancy(1.0, H=16)))
    opt = _types.SimpleNamespace(lr=1e-2, iters=10, max_ray_batch=128, devices=1,
                                 patch_size=1, num_rays=64)
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=str(tmp_path / "clean"),
                           use_checkpoint="scratch", mute=True)
    jt.epoch = 3
    clean = jt.save_checkpoint(full=True)
    _, tm = make_wm_models("fp32")
    tm.reset_extra_state()
    init_tables = tm.trainable["msg_tables"].clone()
    tr = t_twm.WatermarkTrainer("ngp", _opt(), tm, workspace=str(tmp_path / "ws"),
                                use_checkpoint=clean, mute=True)
    assert not tr._wm_state_loaded and tr.global_step == 0
    for k in ("hash_table",):
        assert np.array_equal(tm.backbone[k].numpy(), np.asarray(jm.params[k]))
    for a, b in zip(tm.backbone["sigma_net"], jm.params["sigma_net"]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert torch.equal(tm.occ.occupancy, T(np.asarray(jm.occ.occupancy)))
    assert torch.equal(tm.trainable["msg_tables"], init_tables)


def test_best_checkpoint_without_grid_rebuilds_it(tmp_path):
    _, tm = make_wm_models("fp32")
    ws = str(tmp_path / "ws")
    tr = t_twm.WatermarkTrainer("ngp", _opt(), tm, workspace=ws, use_checkpoint="scratch",
                                mute=True)
    best = tr.save_checkpoint(best=True)
    _, tm2 = make_wm_models("fp32")
    tm2.reset_extra_state()
    t_twm.WatermarkTrainer("ngp", _opt(), tm2, workspace=str(tmp_path / "ws2"),
                           use_checkpoint=best, mute=True)
    # two full update passes of the frozen backbone's density
    assert int(tm2.occ.iter_density) == 2 and bool(tm2.occ.occupancy.any())


def _cli_flags(scene, ws, ckpt, iters=4):
    return [scene, "--workspace", ws, "--cpu", "--cuda_ray", "--wtmk_tcnn", "--ckpt", ckpt,
            "--iters", str(iters), "--grid_size", "16", "--num_rays", "32", "--bound", "1.0",
            "--scale", "1.0", "--dt_gamma", "0", "--min_near", "0.05",
            "--density_thresh", "0.01", "--train_budget", "16", "--infer_budget", "16",
            "--max_steps", "64", "--message_dim", "3", "--num_rows", "4", "--num_cols", "4",
            "--lambda_w", "0.5", "--eval_interval", "100", "--save_interval", "1",
            "--num_images_test", "1", "--n_test_bitacc", "4", "--n_levels", "2",
            "--block_selection", "random"]


def _run_jax_cli(monkeypatch, argv):
    import main_nerf_wtmk as j_main

    monkeypatch.setattr(sys, "argv", ["main_nerf_wtmk.py"] + argv)
    j_main.main()


def test_both_clis_train_and_each_tests_the_others_workspace(tmp_path, monkeypatch):
    """Recipe steps 4-5 through both CLIs on the same clean checkpoint; then
    the port's --test on the JAX workspace and JAX's --test on the port's:
    the same messages decode to the same per-message bit accuracies."""
    from nerf_signature_tpu_torch import main_nerf_wtmk as t_main
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from test_torch_render import ball_occupancy

    scene = write_scene(str(tmp_path / "scene"))
    clean = NGPModel(NGPConfig(bound=1.0, n_levels=2, compute_dtype=torch.float32),
                     grid_size=16, device="cpu", seed=3)
    clean.params["hash_table"].mul_(1e4)
    clean.occ = clean.occ._replace(occupancy=T(ball_occupancy(1.0, H=16)))
    ckpt = str(tmp_path / "clean" / "ngp_ep0001.ckpt")
    t_ckpt.save_checkpoint(ckpt, {"params": clean.params, "occ": clean.occ})
    ws_t, ws_j = str(tmp_path / "ws_t"), str(tmp_path / "ws_j")
    assert t_main.main(_cli_flags(scene, ws_t, ckpt)) == 0
    _run_jax_cli(monkeypatch, _cli_flags(scene, ws_j, ckpt))
    for ws in (ws_t, ws_j):
        names = os.listdir(ws)
        for want in ("key_poses.npy", "key_blocks.npy", "gt_blocks", "pseudo_gt.npz",
                     "test_image_from_testviews"):
            assert want in names, (ws, want)
        assert os.listdir(os.path.join(ws, "checkpoints"))
    assert np.array_equal(np.load(os.path.join(ws_t, "key_blocks.npy")),
                          np.load(os.path.join(ws_j, "key_blocks.npy")))
    # --test across: on each workspace both packages decode the same
    # messages (same seed) from the same checkpoint; bitacc.txt gets each
    # run's per-message accuracies
    def records(ws):
        with open(os.path.join(ws, "bitacc.txt")) as f:
            return [float(v) for v in f.read().split()]

    assert t_main.main(_cli_flags(scene, ws_j, "latest") + ["--test"]) == 0
    _run_jax_cli(monkeypatch, _cli_flags(scene, ws_j, "latest") + ["--test"])
    _run_jax_cli(monkeypatch, _cli_flags(scene, ws_t, "latest") + ["--test"])
    assert t_main.main(_cli_flags(scene, ws_t, "latest") + ["--test"]) == 0
    for ws in (ws_j, ws_t):
        r = records(ws)
        assert len(r) == 8 and r[:4] == r[4:], (ws, r)
