"""Clean-stage trainer (counterpart of
``nerf_signature_tpu/train/trainer.py:Trainer``): the train step (render,
MSE, backward through the kernels, Adam, EMA), the epoch loop with grid
maintenance and the budget/compaction/group adaptations, checkpoints in the
JAX format (optimizer state included) with the ring buffer and the best
checkpoint, evaluation and the test render.

Randomness is explicit: the per-step random background and march noise are
drawn from the model's ``torch.Generator`` and handed to the renderer as
tensors (JAX splits a key into the same two draws).  ``train_device`` runs
K steps a dispatch on the device (``train/device_loop.py``; on the card a
replayed CUDA graph of the step).

Train-step options: ``--t_cull`` marches the float render grid (K2's cull
route) once the grid's 16 full updates are done (the fog gate); the
evaluation and test renders stay exact.  ``--error_map`` samples pixels
from a per-view coarse error map and EMA-updates it (on the host per step,
on the device in the loop).  ``--patch_size N --lambda_ssim w`` adds
``w * (1 - SSIM)`` over the batch's N x N patches.  ``--stochastic_hash_grad``
(with ``--hash_level_stride N``) takes K7's one-corner backward for the
hash table, and ``--hash_fwd_corners 1`` its one-corner forward, inside the
optimisation step only (``cfg_train``): evaluation, the test render and the
grid updates stay exact.  With ``--bg_radius > 0`` the bg-sphere model
(K8 and ``bg_net``) colours each ray's background and trains with the
field: the ground truth composites over white and no random background is
drawn.  ``--patch_size N`` (N >= 32) with LPIPS weights adds ``1e-3 *
mean(LPIPS)`` over the batch's N x N patches (per step only, as in JAX).
``--clip_text`` trains GT-free ``--rand_pose`` bundles on the CLIP guidance
loss (``_train_step_clip``; weights through ``--clip_model``, none ship).
Training with ``cuda_ray`` off is refused (ROADMAP queue 3: JAX's trainer
marches an occupancy grid it never fills there); serving with it renders
through the fixed-step path.  ``--devices > 1`` raises
``NotImplementedError`` naming its ROADMAP item.
"""

import dataclasses
import json
import math
import os
import pickle
import struct
import time
import zlib

import numpy as np
import torch

from ..api import NGPModel
from ..models.ngp import background_fn, field_params, ngp_field
from ..ops.grid import render_grid, update_occupancy_grid
from ..ops.marching import num_candidates
from ..render.renderer import render_rays_occ
from .checkpoint import (
    check_params_like,
    checkpoint_candidates,
    load_checkpoint,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    prune_checkpoints,
    save_checkpoint,
)
from .device_loop import (
    SSIM_WITH_ERROR_MAP,
    adam_step,
    device_train_loop,
    drop_graph,
    preload,
    prepare_device_loop,
    set_lr,
)
from .metrics import PSNRMeter, ssim_torch


def srgb_to_linear(x):
    """ref ``nerf/utils.py:48-50``."""
    return np.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def make_lr_schedule(lr, iters):
    """``lr * 0.1 ** min(count / iters, 1)`` in float32, like the JAX
    schedule (ref ``main_nerf.py:127``)."""
    f32 = np.float32

    def schedule(count):
        frac = np.minimum(f32(count) / f32(iters), f32(1.0))
        return float(f32(lr) * np.power(f32(0.1), frac))

    return schedule


def param_leaves(params):
    """The params dict's tensors in a fixed order (the optimizer's order),
    the bg-sphere model's last where there is one."""
    bg = [params["bg_table"], *params["bg_net"]] if "bg_table" in params else []
    return [params["hash_table"], *params["sigma_net"], *params["color_net"], *bg]


def train_cfg(cfg, opt):
    """The field config of the optimisation step: cfg with ``--hash_fwd_corners``
    (JAX's ``Trainer.cfg_train``); every other path keeps cfg's exact
    8-corner interpolation.  ``--hash_fwd_corners 1`` needs
    ``--stochastic_hash_grad`` (checked on cfg, the field's own config)."""
    fwd_corners = int(getattr(opt, "hash_fwd_corners", 8) or 8)
    if fwd_corners != 8 and not cfg.stochastic_hash_grad:
        raise ValueError("--hash_fwd_corners 1 requires --stochastic_hash_grad")
    if fwd_corners == cfg.hash_fwd_corners:
        return cfg
    return dataclasses.replace(cfg, hash_fwd_corners=fwd_corners)


def make_optimizer(params, lr):
    """Adam(betas=(0.9, 0.99), eps=1e-15) over the params' leaves, ref
    ``main_nerf.py:122``; the caller sets each step's lr from the schedule."""
    return torch.optim.Adam(param_leaves(params), lr=lr, betas=(0.9, 0.99), eps=1e-15)


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
    """Holds the model, its optimizer and EMA params, and the workspace."""

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
        _refuse_unported(opt)
        self.cfg_train = train_cfg(model.cfg, opt)
        # the weight-free structural patch guard (shared with the watermark
        # stage): lambda_ssim * (1 - SSIM) over patch-structured batches
        self.patch_size = int(getattr(opt, "patch_size", 1) or 1)
        self.lambda_ssim = float(getattr(opt, "lambda_ssim", 0.0) or 0.0)
        if self.lambda_ssim > 0 and self.patch_size <= 1:
            raise ValueError("--lambda_ssim needs --patch_size > 1 "
                             "(patch-structured ray batches)")

        for p in param_leaves(model.params):
            p.requires_grad_(True)
        self.lr_schedule = make_lr_schedule(opt.lr, opt.iters)
        self.optimizer = make_optimizer(model.params, opt.lr)
        self.ema_params = _clone(model.params)
        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "valid_loss": [], "results": [],
                      "checkpoints": [], "best_result": None}
        self._budget_hysteresis = 0
        self._group_hysteresis = 0
        self._compact_pending = None
        # the device loop: the grid's updates counted on the host, the
        # device lr schedule (card), the live CUDA graph of the step
        self.grid_updates = None
        self.device_schedule = None
        self.step_graph = None

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
        # the patch LPIPS loss (ref utils.py:374-377,528): weights resolved
        # once; without them, or on patches below MIN_SIZE, one skip line
        self._lpips_params = None
        if self.patch_size > 1:
            from ..utils.lpips import MIN_SIZE, load_lpips_params

            self._lpips_params = load_lpips_params(getattr(opt, "lpips_weights", None),
                                                   model.device)
            if self._lpips_params is None:
                self.log("[lpips] patch LPIPS loss skipped: no weights "
                         "(set --lpips_weights or install lpips)")
            elif self.patch_size < MIN_SIZE:
                self.log(f"[lpips] patch LPIPS loss skipped: patch_size "
                         f"{self.patch_size} < {MIN_SIZE} (AlexNet stack "
                         f"collapses)")
                self._lpips_params = None
            if self._lpips_params is not None:
                self.log("[lpips] patch LPIPS loss active (1e-3, in-graph)")
        if self.lambda_ssim > 0:
            self.log(f"[ssim] patch SSIM guard active (lambda={self.lambda_ssim}, in-graph)")
        # GT-free CLIP guidance (ref nerf/utils.py:474-489): asking for it
        # without weights is an error, not a silent no-op
        self._clip = None
        clip_text = getattr(opt, "clip_text", "") or ""
        if clip_text:
            from ..utils.clip_loss import CLIPLoss

            clip = CLIPLoss(getattr(opt, "clip_model", None) or "openai/clip-vit-base-patch32",
                            device=model.device)
            if not clip.available:
                raise RuntimeError(clip.error)
            clip.prepare_text([clip_text])
            self._clip = clip
            self.log(f"[clip] GT-free guidance active: {clip_text!r}")

    # ------------------------------------------------------------------ util
    def log(self, *args):
        if not self.mute:
            print(*args, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as f:
                print(*args, file=f)

    def log_metrics(self, **scalars):
        """One JSON line of scalars per call in ``metrics.jsonl``."""
        if not self.workspace:
            return
        with open(os.path.join(self.workspace, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": self.global_step, **scalars}) + "\n")

    # ------------------------------------------------------------ adaptation
    def _adapt_compaction(self, mean_occ, immediate=False):
        """Auto sample-compaction (``--compact_frac -1``): the slot fraction
        from measured occupancy (1.3x headroom, 1/16 buckets, a 2/16 lower
        dead-band, two-in-a-row hysteresis), as the JAX trainer picks it."""
        if getattr(self.opt, "compact_frac", 0) != -1:
            return
        m = self.model
        S = m.train_budget
        fill = min(float(mean_occ), S) / S
        target = min(1.0, math.ceil(1.3 * fill * 16.0) / 16.0)
        cur = m.rc.compact_frac or 1.0
        if target == cur or (not immediate and target < cur and cur - target < 0.125):
            self._compact_pending = None
            return
        if immediate or self._compact_pending == target:
            m.rc = dataclasses.replace(m.rc, compact_frac=0.0 if target == 1.0 else target)
            self._compact_pending = None
            self.log(f"[compact] sample compaction -> {target}")
        else:
            self._compact_pending = target

    def _adapt_budget(self, n_occ):
        """The static march budget follows the smallest power of two >=
        1.5 x mean(n_occ) (floor 32, cap max_steps), one bucket per two
        agreeing checks; a move re-fits the compaction at once."""
        mean = float(np.asarray(n_occ).mean())
        b = self.model.train_budget
        target = 1 << max(5, int(np.ceil(np.log2(max(1.5 * mean, 1.0)))))
        target = min(target, self.opt.max_steps)
        if target > b:
            self._budget_hysteresis = max(self._budget_hysteresis, 0) + 1
        elif target < b:
            self._budget_hysteresis = min(self._budget_hysteresis, 0) - 1
        else:
            self._budget_hysteresis = 0
        moved = False
        if self._budget_hysteresis >= 2:
            self.model.train_budget = min(b * 2, self.opt.max_steps)
            self._budget_hysteresis = 0
            moved = True
            self.log(f"[budget] raise march budget -> {self.model.train_budget}")
        elif self._budget_hysteresis <= -2:
            self.model.train_budget = max(b // 2, 32)
            self._budget_hysteresis = 0
            moved = True
            self.log(f"[budget] lower march budget -> {self.model.train_budget}")
        if moved:
            self._adapt_compaction(mean, immediate=True)

    def _adapt_group_budget(self, mean_groups):
        """March coarse-group budget (``--group_budget -1``): the same
        1.5x-mean power-of-two rule fed by the uncapped ``n_groups_occ``,
        floor 16 groups, idle until the grid's 16 full updates are done."""
        if getattr(self.opt, "group_budget", 0) != -1:
            return
        m = self.model
        if int(m.occ.iter_density) < 16:
            self._group_hysteresis = 0
            return
        rc = m.rc
        n_groups_max = max(num_candidates(rc.bound, rc.max_steps, rc.dt_gamma) // 4, 1)
        cur = rc.group_budget or max(64, m.train_budget // 2)
        target = 1 << max(4, int(np.ceil(np.log2(max(1.5 * mean_groups, 1.0)))))
        target = min(target, n_groups_max)
        if target > cur:
            self._group_hysteresis = max(self._group_hysteresis, 0) + 1
        elif target < cur:
            self._group_hysteresis = min(self._group_hysteresis, 0) - 1
        else:
            self._group_hysteresis = 0
        if self._group_hysteresis >= 2:
            m.rc = dataclasses.replace(rc, group_budget=min(max(cur * 2, 16), n_groups_max))
            self._group_hysteresis = 0
            self.log(f"[group] raise march group budget -> {m.rc.group_budget}")
        elif self._group_hysteresis <= -2:
            m.rc = dataclasses.replace(rc, group_budget=max(cur // 2, 16))
            self._group_hysteresis = 0
            self.log(f"[group] lower march group budget -> {m.rc.group_budget}")

    def _rc_train(self):
        """RenderConfig of the next step: the t_cull fog gate (march exact
        until the grid's 16 full updates are done)."""
        rc = self.model.rc
        if rc.t_cull and int(self.model.occ.iter_density) < 16:
            return dataclasses.replace(rc, t_cull=0.0)
        return rc

    # ----------------------------------------------------------------- train
    def _train_step(self, rays_o, rays_d, images, bg, noise, rc, budget):
        """One optimisation step on [N, 3] rays and [N, 3 or 4] images with
        the given draws (bg [N, 3] or [1, 3], noise [N]), the field at
        ``cfg_train``; with the bg-sphere model its colour replaces ``bg`` in
        the render (``bg`` then white, for the ground truth).  Returns (loss,
        per_ray, n_occupied, n_occupied_raw, n_groups_occ), detached."""
        m = self.model
        cfg = self.cfg_train
        if images.shape[-1] == 4:
            gt = images[..., :3] * images[..., 3:] + bg * (1.0 - images[..., 3:])
        else:
            gt = images
        fp = field_params(m.params, cfg)
        out = render_rays_occ(
            lambda x, d: ngp_field(fp, cfg, x, d), render_grid(m.occ, rc.t_cull),
            rays_o, rays_d, rc, budget=budget, bg_color=bg, noise=noise,
            bg_fn=background_fn(fp, cfg))
        per_ray = torch.mean((out["image"] - gt) ** 2, dim=-1)
        loss = torch.mean(per_ray)
        if self._lpips_params is not None:
            from ..utils.lpips import lpips_distance

            loss = loss + 1e-3 * torch.mean(lpips_distance(
                self._lpips_params, *patches(out["image"], gt, self.patch_size)))
        if self.lambda_ssim > 0:
            loss = loss + self.lambda_ssim * (1.0 - patch_ssim(out["image"], gt,
                                                               self.patch_size))
        self._optimize(loss)
        return (loss.detach(), per_ray.detach(), out["n_occupied"],
                out["n_occupied_raw"], out["n_groups_occ"])

    def _optimize(self, loss):
        """Backward, Adam at the scheduled lr, then the EMA."""
        m = self.model
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(self.optimizer, param_leaves(m.params)[0], self.lr_schedule,
               self.device_schedule)
        self.optimizer.step()
        if self.ema_decay is not None:
            with torch.no_grad():
                ema = param_leaves(self.ema_params)
                torch._foreach_mul_(ema, self.ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul(param_leaves(m.params),
                                                            1.0 - self.ema_decay))

    def _train_step_clip(self, rays_o, rays_d, H, W, noise):
        """One GT-free step (JAX ``_make_clip_step``): render the [H * W]
        bundle through the grid at the train budget with march noise
        ``noise`` [N] over white, the CLIP guidance loss of the [1, H, W]
        image, then backward, Adam and the EMA.  The field at ``model.cfg``
        and the grid at ``model.rc``, as JAX's step takes them.  Returns
        the loss, detached."""
        from ..utils.clip_loss import clip_guidance_loss

        m = self.model
        cfg, rc = m.cfg, m.rc
        fp = field_params(m.params, cfg)
        out = render_rays_occ(
            lambda x, d: ngp_field(fp, cfg, x, d), render_grid(m.occ, rc.t_cull),
            rays_o, rays_d, rc, budget=m.train_budget, bg_color=1.0, noise=noise,
            bg_fn=background_fn(fp, cfg))
        loss = clip_guidance_loss(self._clip.params, self._clip.meta,
                                  self._clip.text_features, out["image"].reshape(1, H, W, 3))
        self._optimize(loss)
        return loss.detach()

    def opt_count(self):
        """Adam steps taken (optax's ``count``)."""
        state = self.optimizer.state.get(param_leaves(self.model.params)[0])
        return int(state["step"]) if state else 0

    def draws(self, n, has_alpha):
        """The step's random background [n, 3] (ones without alpha, and with
        the bg-sphere model, as JAX draws none) and march noise [n], from
        the model's generator."""
        m = self.model
        if has_alpha and not m.cfg.bg_radius > 0:
            bg = torch.rand((n, 3), generator=m.generator, device=m.device)
        else:
            bg = torch.ones((1, 3), device=m.device)
        return bg, torch.rand((n,), generator=m.generator, device=m.device)

    def train_step_data(self, data):
        m = self.model
        if not m.use_occ:
            raise NotImplementedError(TRAIN_WITHOUT_GRID)
        dev = m.device
        if "images" not in data:
            # GT-free rand_pose batch: the CLIP step, or an explicit skip
            if self._clip is not None:
                rays_o = torch.as_tensor(np.asarray(data["rays_o"]).reshape(-1, 3), device=dev)
                rays_d = torch.as_tensor(np.asarray(data["rays_d"]).reshape(-1, 3), device=dev)
                noise = torch.rand((rays_o.shape[0],), generator=m.generator, device=dev)
                loss = self._train_step_clip(rays_o, rays_d, int(data["H"]), int(data["W"]),
                                             noise)
                return loss, None, None, None, None
            if not getattr(self, "_warned_gt_free", False):
                self._warned_gt_free = True
                self.log("[train] skipping GT-free rand_pose batches: no --clip_text configured")
            return None, None, None, None, None
        images = np.asarray(data["images"]).reshape(-1, data["images"].shape[-1])
        if getattr(self.opt, "color_space", "srgb") == "linear":
            images = images.copy()
            images[..., :3] = srgb_to_linear(images[..., :3])
        rays_o = torch.as_tensor(np.asarray(data["rays_o"]).reshape(-1, 3), device=dev)
        rays_d = torch.as_tensor(np.asarray(data["rays_d"]).reshape(-1, 3), device=dev)
        images = torch.as_tensor(np.asarray(images, np.float32), device=dev)
        bg, noise = self.draws(rays_o.shape[0], images.shape[-1] == 4)
        return self._train_step(rays_o, rays_d, images, bg, noise, self._rc_train(),
                                m.train_budget)

    def train_one_epoch(self, loader):
        m = self.model
        total_loss, nsteps = 0.0, 0
        t_epoch = time.time()
        error_map = getattr(loader, "error_map", None)
        update_interval = getattr(self.opt, "update_extra_interval", 16)
        for data in loader:
            if (self.global_step % update_interval == 0
                    and self.global_step != getattr(self, "_last_extra", -1)):
                m.update_extra_state()
                self._last_extra = self.global_step
            gt_free = "images" not in data
            loss, per_ray, n_occ, n_occ_raw, n_groups = self.train_step_data(data)
            if loss is None:  # a GT-free batch skipped (no --clip_text)
                continue
            if error_map is not None and "inds_coarse" in data:
                # the EMA at the sampled cells, on the host (ref utils.py:549-556);
                # a patch batch carries no inds_coarse and leaves the map as it is
                update_error_map(error_map, data["index"], data["inds_coarse"],
                                 per_ray.cpu().numpy())
            if self.global_step % update_interval == update_interval - 1 and not gt_free:
                self._adapt_budget(n_occ_raw.cpu().numpy())
                self._adapt_compaction(float(n_occ.float().mean()))
                self._adapt_group_budget(float(n_groups.float().mean()))
            total_loss += float(loss)
            nsteps += 1
            self.global_step += 1
            if self.global_step >= self.opt.iters:
                break
        avg = total_loss / max(nsteps, 1)
        self.stats["loss"].append(avg)
        dt = max(time.time() - t_epoch, 1e-9)
        self.log_metrics(loss=avg, rays_per_sec=nsteps * self.opt.num_rays / dt,
                         train_budget=m.train_budget)
        return avg

    def train_device(self, loader, max_steps=None, steps_per_dispatch=256):
        """On-device training (``train/device_loop.py``): dispatches of K
        steps on the preloaded dataset, and between them, in JAX's order, the
        compaction, march-budget and group-budget adaptations, the metrics
        line, and every ``save_interval`` dispatches a checkpoint and the
        fog-deadlock guard.  With ``--error_map`` the loader's map goes to
        the device, is sampled and updated there, and comes back to the
        loader after every dispatch."""
        m = self.model
        max_steps = max_steps or self.opt.iters
        if not m.use_occ:
            raise NotImplementedError(TRAIN_WITHOUT_GRID)
        # the loop takes the SSIM patch guard but not the LPIPS loss (JAX's
        # message): the AlexNet stack would ride every step of the loop
        if self._lpips_params is not None:
            raise RuntimeError(
                "--patch_size LPIPS loss is not supported with "
                "--steps_per_dispatch scan training; drop "
                "--steps_per_dispatch (per-step path) or unset the LPIPS "
                "weights")
        em_host = getattr(loader, "error_map", None)
        if self.lambda_ssim > 0 and em_host is not None:
            raise RuntimeError(SSIM_WITH_ERROR_MAP)
        data = preload(loader.poses, loader.images, loader.intrinsics, loader.H, loader.W,
                       m.device)
        em = (None if em_host is None else
              torch.as_tensor(np.asarray(em_host, np.float32), device=m.device))
        m.mark_untrained_grid(loader.poses, loader.intrinsics)
        prepare_device_loop(self, param_leaves(m.params))
        update_interval = getattr(self.opt, "update_extra_interval", 16)
        start = time.time()
        while self.global_step < max_steps:
            k = min(steps_per_dispatch, max_steps - self.global_step)
            st = device_train_loop(self, data, k, update_interval=update_interval, error_map=em)
            if em is not None:
                em_host[...] = em.cpu().numpy()
            self.global_step += k
            loss = float(st.losses.mean())
            self.stats["loss"].append(loss)
            rays_s = k * self.opt.num_rays / max(time.time() - start, 1e-9)
            self.log(f"[device loop] step={self.global_step}/{max_steps} "
                     f"loss={st.losses[-1]:.6f} mean_occ={st.mean_occupied:.1f} "
                     f"({rays_s / 1e6:.2f}M rays/s)")
            self.log_metrics(loss=loss, rays_per_sec=rays_s, mean_occ=st.mean_occupied,
                             occ_p95=st.occ_p95, train_budget=m.train_budget)
            self._adapt_compaction(st.mean_occupied)
            self._adapt_budget(st.mean_occupied_raw)
            self._adapt_group_budget(st.mean_groups_occ)
            start = time.time()
            self.epoch += 1
            if self.workspace and self.epoch % max(1, getattr(self.opt, "save_interval", 10)) == 0:
                self.save_checkpoint(full=True)
                prune_checkpoints(self.ckpt_path, self.name, self.max_keep_ckpt)
                self._fog_guard()
        if self.workspace:
            self.save_checkpoint(full=True)
            prune_checkpoints(self.ckpt_path, self.name, self.max_keep_ckpt)

    def _fog_guard(self):
        """Warn once when the grid stays >90% occupied past step 500: the
        march budget is spent on unpruned fog (almost always a too-low
        --density_thresh)."""
        m = self.model
        occ_frac = float(m.occ.occupancy.float().mean())
        self.log(f"[grid] occupancy frac {occ_frac:.3f} "
                 f"mean_density {float(m.occ.mean_density):.3f}")
        if occ_frac > 0.9 and self.global_step > 500 and not getattr(self, "_warned_fog", False):
            self._warned_fog = True
            self.log("[grid] WARNING: occupancy grid is >90% occupied after 500 steps — the "
                     "march budget is being spent on unpruned fog. Raise --density_thresh "
                     "(the torch-ngp Blender recipe uses 10) or check the scene scale.")

    def train(self, train_loader, valid_loader=None, max_epochs=1):
        if not self.model.use_occ:
            raise NotImplementedError(TRAIN_WITHOUT_GRID)
        if getattr(train_loader, "poses", None) is not None:
            self.model.mark_untrained_grid(train_loader.poses, train_loader.intrinsics)
        start = time.time()
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            avg = self.train_one_epoch(train_loader)
            self.log(f"[epoch {epoch}/{max_epochs}] loss={avg:.6f} "
                     f"step={self.global_step} elapsed={time.time() - start:.1f}s")
            if self.workspace:
                self.save_checkpoint(full=True)
                prune_checkpoints(self.ckpt_path, self.name, self.max_keep_ckpt)
            if valid_loader is not None and epoch % self.eval_interval == 0:
                self.evaluate_one_epoch(valid_loader)
            if self.global_step >= self.opt.iters:
                break

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
    def _opt_state(self):
        """Adam's state in optax's layout (zeros before the first step)."""
        params = self.model.params
        mu, nu = {}, {}
        for k, v in params.items():
            vs = v if isinstance(v, list) else [v]
            st = [self.optimizer.state.get(p) for p in vs]
            mus = [s["exp_avg"] if s else torch.zeros_like(p) for s, p in zip(st, vs)]
            nus = [s["exp_avg_sq"] if s else torch.zeros_like(p) for s, p in zip(st, vs)]
            mu[k], nu[k] = (mus, nus) if isinstance(v, list) else (mus[0], nus[0])
        return opt_state_to_jax(self.opt_count(), mu, nu)

    def _load_opt_state(self, state_dict):
        count, mu, nu = opt_state_from_jax(state_dict, self.model.device)
        check_params_like(self.model.params, mu)
        check_params_like(self.model.params, nu)
        for p, a, b in zip(param_leaves(self.model.params), param_leaves(mu), param_leaves(nu)):
            self.optimizer.state[p] = {"step": adam_step(self.optimizer, count, p.device),
                                       "exp_avg": a, "exp_avg_sq": b}

    def _state(self, full=True):
        state = {
            "params": self.model.params,
            "ema_params": self.ema_params,
            "occ": self.model.occ,
            "epoch": self.epoch,
            "global_step": self.global_step,
            "train_budget": self.model.train_budget,
        }
        if full:
            state["opt_state"] = self._opt_state()
        return state

    def save_checkpoint(self, full=True, best=False):
        """Write the JAX package's checkpoint format (the best checkpoint
        drops the grid and the optimizer state, like the reference)."""
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
        """Restore a checkpoint of either package.  Params and EMA are copied
        into the existing tensors, so the optimizer keeps its references."""
        raw = load_checkpoint(path)
        m = self.model
        drop_graph(self)
        params = params_from_jax(raw["params"], m.device)
        check_params_like(m.params, params)
        _copy_into(m.params, params)
        if "ema_params" in raw:
            ema = params_from_jax(raw["ema_params"], m.device)
            check_params_like(m.params, ema)
            _copy_into(self.ema_params, ema)
        if "occ" in raw:
            restore_occupancy(m, raw["occ"])
        if not model_only:
            self.epoch = int(raw.get("epoch", 0))
            self.global_step = int(raw.get("global_step", 0))
            m.train_budget = int(raw.get("train_budget", m.train_budget))
            if "opt_state" in raw:
                try:
                    self._load_opt_state(raw["opt_state"])
                except (KeyError, ValueError, TypeError) as e:
                    self.log(f"[ckpt] optimizer restore failed (soft): {e}")
        self.grid_updates = None
        self.log(f"[ckpt] loaded {path}")
        ensure_occupancy(m, path, self.log)


def patches(image, gt, patch_size):
    """The batch's leading patches of [N, 3] rays whose first
    N // patch_size**2 * patch_size**2 are row-major patch_size**2 grids:
    (image, gt) as [n, patch_size, patch_size, 3]."""
    pp = patch_size
    n = image.shape[0] // (pp * pp)
    return (image[:n * pp * pp].reshape(n, pp, pp, 3),
            gt[:n * pp * pp].reshape(n, pp, pp, 3))


def patch_ssim(image, gt, patch_size):
    """SSIM of the batch's leading patches (``patches``)."""
    return ssim_torch(*patches(image, gt, patch_size))


def update_error_map(error_map, index, inds_coarse, per_ray):
    """The per-step error-map EMA on the host: cells ``inds_coarse`` of
    view ``index`` take ``0.1 * map + 0.9 * per-ray error`` (numpy, a
    repeated cell its last ray's)."""
    inds = np.asarray(inds_coarse).reshape(-1)
    em = error_map[index]
    em[inds] = 0.1 * em[inds] + 0.9 * np.asarray(per_ray).reshape(-1)
    error_map[index] = em


def restore_occupancy(model, occ_state):
    """Load a checkpoint's grid fields into ``model.occ``, checking shapes."""
    fields = {}
    for k, v in occ_state.items():
        cur = getattr(model.occ, k)
        t = torch.as_tensor(np.asarray(v)).to(model.device)
        if cur is not None:
            if tuple(t.shape) != tuple(cur.shape):
                raise ValueError(
                    f"checkpoint grid {k!r} has shape {tuple(t.shape)}, "
                    f"model has {tuple(cur.shape)} (grid_size/bound differ?)")
            t = t.to(cur.dtype)
        fields[k] = t
    model.occ = model.occ._replace(**fields)


def ensure_occupancy(model, path, log):
    """Best-format checkpoints drop the density grid: rebuild it from the
    loaded density field (two full-grid passes through K1 + K4); nothing
    without the occupancy grid (``cuda_ray`` off)."""
    m = model
    if not m.use_occ or bool(m.occ.occupancy.any()):
        return
    log(f"[ckpt] {path} carries no occupancy grid (best-ckpt format "
        "drops it) — rebuilding from the density field")
    for _ in range(2):
        m.occ = update_occupancy_grid(
            m.occ, m.density_fn, bound=m.rc.bound, grid_size=m.rc.grid_size,
            density_scale=m.rc.density_scale, density_thresh=m.density_thresh,
            full=True, generator=m.generator)
    frac = float(m.occ.occupancy.float().mean())
    log(f"[ckpt] rebuilt occupancy grid: {frac:.3f} occupied")
    if frac == 0.0:
        raise RuntimeError(
            "occupancy rebuild produced an empty grid — the model in "
            f"{path} renders nothing (wrong checkpoint, or density_thresh "
            f"{m.density_thresh} too high for this scene)")


def _clone(params):
    return {k: [w.detach().clone() for w in v] if isinstance(v, list) else v.detach().clone()
            for k, v in params.items()}


@torch.no_grad()
def _copy_into(dst, src):
    for a, b in zip(param_leaves(dst), param_leaves(src)):
        a.copy_(b)


TRAIN_WITHOUT_GRID = (
    "training with cuda_ray off is refused (ROADMAP queue 3: 'training with cuda_ray off "
    "trains nothing in the reference'): JAX's train step marches an occupancy grid that "
    "it never updates there, so every ray renders the background and the field takes no "
    "gradient. Train with -O / --cuda_ray; serving with cuda_ray off renders through the "
    "fixed-step path.")


def _refuse_unported(opt):
    """Raise on the train-path options this slice does not port."""
    if getattr(opt, "devices", 0) > 1:
        raise NotImplementedError(
            "not ported yet: --devices > 1 (ROADMAP: parallel/ as DDP over NCCL)")
