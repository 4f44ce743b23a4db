"""The port's serving path end to end on the CPU: the serving ``Trainer``
(checkpoint resolution, ``evaluate_one_epoch``, ``test``, the occupancy
rebuild) against the JAX ``Trainer`` on the same checkpoint and the same
in-memory ball-scene loader; and the CLI ``--test --cpu`` on a tiny
Blender-format ball dataset written here.

Tolerance: eval PSNR within 0.05 dB of JAX and eval loss within 1e-5 (fp32
field; the renders agree to ~1e-5 per pixel, test_torch_render); the uint8
test frames above 40 dB against JAX's (a pixel may round to the
neighbouring 8-bit level).
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.train.trainer import Trainer as JTrainer
from nerf_signature_tpu_torch.data.rays import get_rays, rand_poses
from nerf_signature_tpu_torch.train.metrics import LPIPSMeter, PSNRMeter, SSIMMeter
from nerf_signature_tpu_torch.train.trainer import Trainer as TTrainer
from test_torch_render import make_models, psnr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16
FOCAL_ANGLE = 0.8


def ball_rgba(rays_o, rays_d, radius=0.4):
    """Analytic textured ball (RGBA), as the repo's ball dataset draws it."""
    b = np.sum(rays_o * rays_d, -1)
    c = np.sum(rays_o * rays_o, -1) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    p = rays_o + t[..., None] * rays_d
    rgba = np.zeros((*rays_o.shape[:-1], 4), np.float32)
    rgba[..., 0] = np.where(hit, 0.6 + 0.4 * np.sin(8 * p[..., 0]), 0)
    rgba[..., 1] = np.where(hit, 0.5 + 0.5 * np.cos(7 * p[..., 1]), 0)
    rgba[..., 2] = np.where(hit, 0.3, 0)
    rgba[..., 3] = hit.astype(np.float32)
    return np.clip(rgba, 0, 1)


def ball_loader(n=2, res=RES, seed=0):
    rng = np.random.default_rng(seed)
    poses = rand_poses(rng, n, radius=1.8)
    fl = res / (2 * np.tan(FOCAL_ANGLE / 2))
    out = []
    for p in poses:
        r = get_rays(p[None], (fl, fl, res / 2, res / 2), res, res, -1)
        img = ball_rgba(r["rays_o"][0], r["rays_d"][0]).reshape(1, res, res, 4)
        out.append({"H": res, "W": res, "rays_o": r["rays_o"], "rays_d": r["rays_d"],
                    "images": img})
    return out


def _opt(**kw):
    d = dict(lr=1e-2, iters=10, max_ray_batch=128, devices=1, patch_size=1, num_rays=256)
    d.update(kw)
    return types.SimpleNamespace(**d)


def test_serving_trainer_matches_jax_trainer(tmp_path):
    jm, tm = make_models("fp32", 1.0)
    ws_j, ws_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    jt = JTrainer("ngp", _opt(), jm, workspace=ws_j, use_checkpoint="scratch", mute=True)
    jt.ema_params = jm.params
    jt.epoch = 4
    ckpt = jt.save_checkpoint(full=True)

    # both read the same JAX checkpoint through "latest" resolution
    os.makedirs(os.path.join(ws_t, "checkpoints"))
    os.link(ckpt, os.path.join(ws_t, "checkpoints", os.path.basename(ckpt)))
    tt = TTrainer("ngp", _opt(), tm, workspace=ws_t, use_checkpoint="latest", mute=True,
                  metrics=[PSNRMeter(), SSIMMeter(), LPIPSMeter()])
    # Adam's state is restored from optax's (count 0, zero moments)
    assert tt.epoch == 4 and tt.opt_count() == 0 and len(tt.optimizer.state) == 6

    loader = ball_loader()
    loss_j = jt.evaluate_one_epoch(loader)
    loss_t = tt.evaluate_one_epoch(loader)
    p_j, p_t = jt.metrics[0].measure(), tt.metrics[0].measure()
    assert abs(p_j - p_t) < 0.05 and abs(loss_j - loss_t) < 1e-5
    assert tt.metrics[2].measure() is None and "n/a" in tt.metrics[2].report()
    assert os.path.exists(os.path.join(ws_t, "checkpoints", "ngp.ckpt"))  # best ckpt

    fj = jt.test(loader, save_path=str(tmp_path / "rj"))
    ft = tt.test(loader, save_path=str(tmp_path / "rt"))
    assert len(ft) == 2 and ft[0].shape == (RES, RES, 3)
    assert psnr(np.stack(ft) / 255.0, np.stack(fj) / 255.0) > 40.0
    assert sorted(os.listdir(tmp_path / "rt")) == ["ngp_0000_rgb.png", "ngp_0001_rgb.png"]


def test_best_checkpoint_without_grid_rebuilds_occupancy(tmp_path):
    jm, tm = make_models("fp32", 1.0)
    tm.occ = tm.occ._replace(occupancy=torch.zeros_like(tm.occ.occupancy))
    tt = TTrainer("ngp", _opt(), tm, workspace=str(tmp_path), use_checkpoint="scratch",
                  mute=True)
    best = tt.save_checkpoint(best=True)  # drops the grid
    fresh = make_models("fp32", 1.0)[1]
    fresh.occ = fresh.occ._replace(occupancy=torch.zeros_like(fresh.occ.occupancy))
    fresh.density_thresh = 1.0
    TTrainer("ngp", _opt(), fresh, workspace=str(tmp_path / "w2"), use_checkpoint=best,
             mute=True)
    frac = float(fresh.occ.occupancy.float().mean())
    assert 0.0 < frac < 1.0 and int(fresh.occ.iter_density) == 2
    # the rebuilt model trains: two steps on two ball views
    trainer = TTrainer("ngp", _opt(), fresh, workspace=None, mute=True)
    trainer.train(ball_loader(), None, max_epochs=1)
    assert trainer.global_step == 2 and trainer.opt_count() == 2


def _write_ball_scene(root, res=RES):
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for split, n in [("train", 1), ("val", 1), ("test", 2)]:
        frames = []
        for i, pose in enumerate(rand_poses(rng, n, radius=1.8)):
            # invert the provider's nerf->ngp axis swap (scale 1)
            inv = np.eye(4, dtype=np.float32)
            inv[0] = [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3]]
            inv[1] = [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3]]
            inv[2] = [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3]]
            fl = res / (2 * np.tan(FOCAL_ANGLE / 2))
            r = get_rays(pose[None], (fl, fl, res / 2, res / 2), res, res, -1)
            rgba = ball_rgba(r["rays_o"][0], r["rays_d"][0]).reshape(res, res, 4)
            name = f"r_{split}_{i}.png"
            cv2.imwrite(os.path.join(root, name),
                        cv2.cvtColor((rgba * 255).astype(np.uint8), cv2.COLOR_RGBA2BGRA))
            frames.append({"file_path": name, "transform_matrix": inv.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": FOCAL_ANGLE, "frames": frames}, f)


def test_cli_test_mode_on_cpu_writes_pngs_and_mesh(tmp_path):
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig

    scene, ws = str(tmp_path / "scene"), str(tmp_path / "ws")
    _write_ball_scene(scene)
    # a grid-less checkpoint whose density field crosses the mesh threshold
    # (10) somewhere: the CLI rebuilds the grid and meshes it
    cfg = NGPConfig(bound=1.0, n_levels=4, compute_dtype=torch.bfloat16)
    model = NGPModel(cfg, grid_size=32, device="cpu")
    model.params["hash_table"] *= 2e4
    model.params["sigma_net"][1][:, 0] *= 8.0  # ~0.6% of space above sigma 10
    tt = TTrainer("ngp", _opt(), model, workspace=ws, use_checkpoint="scratch", mute=True)
    tt.save_checkpoint(best=True)
    os.replace(tt.best_path, os.path.join(ws, "checkpoints", "ngp_ep0001.ckpt"))

    cmd = [sys.executable, "-m", "nerf_signature_tpu_torch.main_nerf", scene,
           "--workspace", ws, "--cpu", "-O", "--test", "--bound", "1.0",
           "--scale", "1.0", "--dt_gamma", "0", "--grid_size", "32",
           "--max_steps", "128", "--infer_budget", "32", "--n_levels", "4",
           "--density_thresh", "10", "--mesh_resolution", "32"]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "rebuilt occupancy grid" in r.stdout
    assert sorted(os.listdir(os.path.join(ws, "results"))) == [
        "ngp_0000_rgb.png", "ngp_0001_rgb.png"]
    with open(os.path.join(ws, "mesh.ply"), "rb") as f:
        header = f.read(200).decode("latin-1")
    n_verts = int(header.split("element vertex ")[1].split()[0])
    assert n_verts > 0

    # train mode: a few iterations at a tiny config in a fresh workspace,
    # a checkpoint in the JAX format, then --test renders from it
    ws_train = str(tmp_path / "ws_train")
    tiny = ["--cpu", "-O", "--bound", "1.0", "--scale", "1.0", "--dt_gamma", "0",
            "--grid_size", "32", "--max_steps", "128", "--n_levels", "4",
            "--density_thresh", "0.01", "--min_near", "0.05"]
    train = subprocess.run(
        [sys.executable, "-m", "nerf_signature_tpu_torch.main_nerf", scene, "--workspace",
         ws_train, "--iters", "6", "--num_rays", "128", "--train_budget", "32"] + tiny,
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stdout[-3000:] + train.stderr[-3000:]
    assert "[epoch 6/6]" in train.stdout and "[eval]" in train.stdout
    from nerf_signature_tpu.api import NGPModel as JModel
    from nerf_signature_tpu.models.ngp import NGPConfig as JConfig
    from nerf_signature_tpu.train import checkpoint as j_ckpt

    ckpt = j_ckpt.latest_checkpoint(os.path.join(ws_train, "checkpoints"), "ngp")
    raw = j_ckpt.load_checkpoint(ckpt)
    jm = JModel(JConfig(bound=1.0, n_levels=4, compute_dtype=jnp.bfloat16), grid_size=32)
    restored = j_ckpt.restore_like(jm.params, raw["params"])
    assert raw["global_step"] == 6 and int(raw["opt_state"]["0"]["count"]) == 6
    assert all(np.isfinite(np.asarray(v)).all() for v in jax.tree_util.tree_leaves(restored))
    test = subprocess.run(
        [sys.executable, "-m", "nerf_signature_tpu_torch.main_nerf", scene, "--workspace",
         ws_train, "--test", "--infer_budget", "32", "--mesh_resolution", "16"] + tiny,
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert test.returncode == 0, test.stdout[-3000:] + test.stderr[-3000:]
    assert "[ckpt] loaded" in test.stdout
    assert sorted(os.listdir(os.path.join(ws_train, "results"))) == [
        "ngp_0000_rgb.png", "ngp_0001_rgb.png"]
