"""Clean-stage trainer, serving half (counterpart of
``nerf_signature_tpu/train/trainer.py:Trainer``): checkpoint resolution and
loading, the occupancy rebuild for grid-less checkpoints, evaluation and the
test render.  The optimisation methods come with the training slice (ROADMAP
slice 2) and raise until then.
"""

import os
import pickle
import struct
import zlib

import numpy as np
import torch

from ..api import NGPModel
from ..ops.grid import update_occupancy_grid
from .checkpoint import (
    check_params_like,
    checkpoint_candidates,
    load_checkpoint,
    params_from_jax,
    save_checkpoint,
)
from .metrics import PSNRMeter

_TRAINING = ("training lands with the next slice of the port (ROADMAP slice 2: "
             "the clean train step with the backward kernels)")


def write_png(path, img8):
    """[H, W, 3] uint8 -> 8-bit RGB PNG (zlib only, no image library)."""
    img8 = np.ascontiguousarray(img8, np.uint8)
    H, W, C = img8.shape
    raw = b"".join(b"\x00" + img8[y].tobytes() for y in range(H))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


class Trainer:
    """Serving trainer: holds the model, its EMA params and the workspace."""

    def __init__(self, name, opt, model: NGPModel, workspace="workspace",
                 ema_decay=0.95, metrics=None, eval_interval=50,
                 max_keep_ckpt=2, use_checkpoint="latest", mute=False):
        self.name = name
        self.opt = opt
        self.model = model
        self.workspace = workspace
        self.ema_decay = ema_decay
        self.metrics = metrics if metrics is not None else [PSNRMeter()]
        self.eval_interval = eval_interval
        self.max_keep_ckpt = max_keep_ckpt
        self.mute = mute
        self.ema_params = _clone(model.params)
        self.opt_state_raw = None  # restored by the training slice
        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "valid_loss": [], "results": [],
                      "checkpoints": [], "best_result": None}

        if workspace is not None:
            os.makedirs(workspace, exist_ok=True)
            self.ckpt_path = os.path.join(workspace, "checkpoints")
            os.makedirs(self.ckpt_path, exist_ok=True)
            self.log_path = os.path.join(workspace, f"log_{name}.txt")
            self.best_path = os.path.join(self.ckpt_path, f"{name}.ckpt")
        else:
            self.ckpt_path = self.log_path = self.best_path = None

        if use_checkpoint == "scratch" or self.ckpt_path is None:
            pass
        elif use_checkpoint in ("latest", "latest_model", "best"):
            if use_checkpoint == "best" and os.path.exists(self.best_path):
                candidates = [self.best_path]
            else:
                candidates = checkpoint_candidates(self.ckpt_path, name)
            for path in candidates:
                try:
                    self.load_checkpoint(path, model_only="model" in use_checkpoint)
                    break
                except (OSError, EOFError, ValueError, KeyError,
                        pickle.UnpicklingError) as e:
                    self.log(f"[ckpt] {path} unreadable ({e}); falling back to previous")
        elif use_checkpoint and os.path.exists(use_checkpoint):
            self.load_checkpoint(use_checkpoint, model_only=True)

    # ------------------------------------------------------------------ util
    def log(self, *args):
        if not self.mute:
            print(*args, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as f:
                print(*args, file=f)

    # ----------------------------------------------------------------- train
    def train(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING)

    train_one_epoch = train_step_data = train_device = train

    # ------------------------------------------------------------------ eval
    def eval_params(self):
        return self.ema_params if self.ema_decay is not None else self.model.params

    def evaluate_one_epoch(self, loader, name=None):
        """Render every view of ``loader`` with the EMA params, report the
        metrics against the GT composited over white."""
        m = self.model
        for metric in self.metrics:
            metric.clear()
        params_backup, m.params = m.params, self.eval_params()
        total_loss, n = 0.0, 0
        try:
            for data in loader:
                images = np.asarray(data["images"])
                B, H, W, C = images.shape
                gt = (images[..., :3] * images[..., 3:] + (1.0 - images[..., 3:])
                      if C == 4 else images)
                out = m.render(data["rays_o"], data["rays_d"], staged=True,
                               max_ray_batch=getattr(self.opt, "max_ray_batch", 4096))
                pred = out["image"].cpu().numpy().reshape(B, H, W, 3)
                total_loss += float(np.mean((pred - gt) ** 2))
                n += 1
                for metric in self.metrics:
                    metric.update(pred, gt)
        finally:
            m.params = params_backup
        avg = total_loss / max(n, 1)
        self.stats["valid_loss"].append(avg)
        result = self.metrics[0].measure() if self.metrics else -avg
        self.stats["results"].append(result)
        for metric in self.metrics:
            self.log(f"[eval] {metric.report()}")
        if self.workspace and (self.stats["best_result"] is None
                               or result > self.stats["best_result"]):
            self.stats["best_result"] = result
            self.save_checkpoint(best=True)
        return avg

    def test(self, loader, save_path=None, write_video=False, name=None):
        """Render the test trajectory to PNGs.  Returns the uint8 frames.
        (No video: the port carries no video encoder.)"""
        m = self.model
        save_path = save_path or os.path.join(self.workspace, "results")
        os.makedirs(save_path, exist_ok=True)
        frames = []
        params_backup, m.params = m.params, self.eval_params()
        try:
            for i, data in enumerate(loader):
                out = m.render(data["rays_o"], data["rays_d"], staged=True,
                               max_ray_batch=getattr(self.opt, "max_ray_batch", 4096))
                H, W = data["H"], data["W"]
                img = out["image"].cpu().numpy().reshape(H, W, 3)
                img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
                frames.append(img8)
                write_png(os.path.join(save_path, f"{self.name}_{i:04d}_rgb.png"), img8)
        finally:
            m.params = params_backup
        if write_video and frames:
            self.log("[test] video writing is not ported; PNG frames only")
        return frames

    # ------------------------------------------------------------ checkpoint
    def _state(self, full=True):
        state = {
            "params": self.model.params,
            "ema_params": self.ema_params,
            "occ": self.model.occ,
            "epoch": self.epoch,
            "global_step": self.global_step,
            "train_budget": self.model.train_budget,
        }
        if full and self.opt_state_raw is not None:
            state["opt_state"] = self.opt_state_raw
        return state

    def save_checkpoint(self, full=True, best=False):
        """Write the JAX package's checkpoint format (the best checkpoint
        drops the grid, like the reference)."""
        if best:
            state = self._state(full=False)
            state.pop("occ")
            save_checkpoint(self.best_path, state)
            return self.best_path
        path = os.path.join(self.ckpt_path, f"{self.name}_ep{self.epoch:04d}.ckpt")
        save_checkpoint(path, self._state(full=full))
        self.stats["checkpoints"].append(path)
        return path

    def load_checkpoint(self, path, model_only=False):
        raw = load_checkpoint(path)
        m = self.model
        params = params_from_jax(raw["params"], m.device)
        check_params_like(m.params, params)
        m.params = params
        if "ema_params" in raw:
            ema = params_from_jax(raw["ema_params"], m.device)
            check_params_like(m.params, ema)
            self.ema_params = ema
        if "occ" in raw:
            fields = {}
            for k, v in raw["occ"].items():
                cur = getattr(m.occ, k)
                t = torch.as_tensor(np.asarray(v)).to(m.device)
                if cur is not None:
                    if tuple(t.shape) != tuple(cur.shape):
                        raise ValueError(
                            f"checkpoint grid {k!r} has shape {tuple(t.shape)}, "
                            f"model has {tuple(cur.shape)} (grid_size/bound differ?)")
                    t = t.to(cur.dtype)
                fields[k] = t
            m.occ = m.occ._replace(**fields)
        if not model_only:
            self.epoch = int(raw.get("epoch", 0))
            self.global_step = int(raw.get("global_step", 0))
            m.train_budget = int(raw.get("train_budget", m.train_budget))
            # kept raw for the training slice; not restored into an optimizer
            self.opt_state_raw = raw.get("opt_state")
        self.log(f"[ckpt] loaded {path}")
        self._ensure_occupancy(path)

    def _ensure_occupancy(self, path):
        """Best-format checkpoints drop the density grid: rebuild it from the
        loaded density field (two full-grid passes through K1 + K4)."""
        m = self.model
        if bool(m.occ.occupancy.any()):
            return
        self.log(f"[ckpt] {path} carries no occupancy grid (best-ckpt format "
                 "drops it) — rebuilding from the density field")
        for _ in range(2):
            m.occ = update_occupancy_grid(
                m.occ, m.density_fn, bound=m.rc.bound, grid_size=m.rc.grid_size,
                density_scale=m.rc.density_scale, density_thresh=m.density_thresh,
                full=True, generator=m.generator)
        frac = float(m.occ.occupancy.float().mean())
        self.log(f"[ckpt] rebuilt occupancy grid: {frac:.3f} occupied")
        if frac == 0.0:
            raise RuntimeError(
                "occupancy rebuild produced an empty grid — the model in "
                f"{path} renders nothing (wrong checkpoint, or density_thresh "
                f"{m.density_thresh} too high for this scene)")


def _clone(params):
    return {k: [w.clone() for w in v] if isinstance(v, list) else v.clone()
            for k, v in params.items()}
