"""Watermark-stage trainer (counterpart of
``nerf_signature_tpu/train/trainer_wtmk.py``): embed the codebook message
into a frozen clean model and train the HiDDeN bit extractor, then verify
ownership (bit accuracy over random messages, with its p-value) and image
quality against the pseudo-GT.

A train step: a fresh random message; the key blocks and the content rays
rendered through the watermarked field (K2, K1 twice, K9, K4, K3; in ONE
``render_rays_occ`` call when their budgets are equal) -> clamp -> distort
-> HiDDeN decode (1 bit a block) -> ``lambda_w * loss_w + lambda_i * MSE``
(+ ``lambda_msg_reg * mean(eff^2)``) -> backward into the ``trainable``
tree only (the message tables through K9's backward, the decoder through
cuDNN) -> Adam (0.9, 0.99, eps 1e-15) with ``lr * 0.1 ** min(t / T, 1)``.
The occupancy grid is the clean model's, frozen; only
``mark_untrained_grid`` runs at the start.

The paper's baselines: ``--whole_image_wm`` and ``--copyrnerf`` decode all D
bits from one whole key image, strided to at most 96 pixels a side
(``wm_rays``), as ``[1, D]``; under ``--copyrnerf`` the message reaches the
colour through the CopyRNeRF MLP (K1, K4 with the density logit, K10, the
MLP; no K9, and no backward of K1 or K4).  ``--finetune_decoder`` trains the
decoder alone: the message tables (or MLP) take no gradient and stay as
loaded, and the checkpoint's optimizer state is JAX's ``multi_transform``
layout (``checkpoint.masked_opt_state_to_jax``).

Randomness is explicit: messages come from a numpy generator seeded like
JAX's (the same seed gives the same messages in both packages), the
distortions' draws from the model's ``torch.Generator``.

Multi-view keys (``--n_views V > 1``): the key blocks render from V key
poses ([D, V, bh, bw, 3] ray bundles) and reach the decoder
channel-concatenated, [D, bh, bw, V*3]; distortions and the normalisation
run per view (``_per_view``), their draws made at the per-view batch shape
[D*V, bh, bw, 3].  ``train_device`` runs K steps a dispatch on the device
(``train/device_loop.py:wm_device_loop``; on the card a replayed CUDA graph
of the step), its messages and distortion draws made on the device.

``--stochastic_hash_grad --hash_fwd_corners 1`` (``wcfg_train``) makes the
step's backbone encode K7's one-corner forward; the message encode, the
decodes of verification, the test images and the pseudo-GT stay exact.
With a backbone that has the bg-sphere model (``--bg_radius > 0``), every
render of key blocks, content rays and pseudo-GT takes the frozen
backbone's background (``_bg_fn``).  Not ported yet (it raises
``NotImplementedError`` naming its ROADMAP item): ``--devices > 1``.
"""

import dataclasses
import json
import math
import os
import pickle
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..api import WatermarkModel
from ..data.rays import get_rays
from ..models.copyrnerf import mlp_leaves
from ..models.hidden import decoder_leaves, hidden_decoder_apply, normalize_img
from ..models.ngp import background_fn
from ..models.watermark import wtmk_field, wtmk_field_params
from ..ops.grid import render_grid
from ..ops.marching import num_candidates
from ..render.renderer import render_rays_occ
from ..utils.image import distortion_draws, distortion_layer
from .checkpoint import (
    check_params_like,
    checkpoint_candidates,
    load_checkpoint,
    masked_opt_state_from_jax,
    masked_opt_state_to_jax,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    prune_checkpoints,
    save_checkpoint,
    to_state_dict,
    trainable_from_jax,
    trainable_to_jax,
)
from .device_loop import (
    adam_step,
    drop_graph,
    preload,
    prepare_device_loop,
    set_lr,
    wm_device_loop,
)
from .metrics import BitAccMeter, PSNRMeter, SSIMMeter
from .trainer import (
    ensure_occupancy,
    make_lr_schedule,
    patch_ssim,
    restore_occupancy,
    train_cfg,
    write_png,
)

_CKPT_ERRORS = (OSError, EOFError, ValueError, KeyError, pickle.UnpicklingError)


def make_loss_w(kind, temp=10.0):
    """ref ``utils_wtmk_disen.py:438-443``: MSE against +-1, or BCE on
    ``temp * logit`` (optax's ``sigmoid_binary_cross_entropy`` formula)."""
    if kind == "mse":
        return lambda decoded, bits: torch.mean((decoded * temp - (2.0 * bits - 1.0)) ** 2)
    if kind == "bce":
        def bce(decoded, bits):
            x = decoded * temp
            return torch.mean(-bits * F.logsigmoid(x) - (1.0 - bits) * F.logsigmoid(-x))
        return bce
    raise NotImplementedError(kind)


def trainable_leaves(trainable):
    """The trainable tree's tensors in a fixed order: the message tables (or
    the CopyRNeRF MLP's leaves), then the decoder's."""
    msg = ([trainable["msg_tables"]] if "msg_tables" in trainable
           else mlp_leaves(trainable["msg_mlp"]))
    return msg + decoder_leaves(trainable["decoder"])


def optimized_leaves(trainable, finetune_decoder):
    """The leaves Adam steps: the decoder's alone under
    ``--finetune_decoder``, else every trainable leaf."""
    if finetune_decoder:
        return decoder_leaves(trainable["decoder"])
    return trainable_leaves(trainable)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def wm_rays(wcfg, wm):
    """The decoder's ray bundles from a watermark data dict: the key blocks
    [D, bh, bw, 3], or [D, V, bh, bw, 3] with V key views; in the
    whole-image modes (``whole_image``, ``copyrnerf``) the whole key image
    [1, H, W, 3] strided by ``ceil(max(H, W) / 96)``.  Shared by the
    trainer and the attack suites, so every decode reads the same rays."""
    if not (wcfg.whole_image or wcfg.copyrnerf):
        return wm["rays_o_block"], wm["rays_d_block"]
    ro, rd = wm["rays_o"], wm["rays_d"]
    s = max(1, int(np.ceil(max(ro.shape[1], ro.shape[2]) / 96)))
    return ro[:, ::s, ::s], rd[:, ::s, ::s]


def _blocks(image, rays_shape):
    """The rendered pixels of ray bundles of ``rays_shape`` -> the decoder's
    blocks in [0, 1]: [D, bh, bw, 3], or from [D, V, bh, bw, 3] the views
    channel-concatenated, [D, bh, bw, V*3]."""
    img = torch.clamp(image.reshape(rays_shape), 0.0, 1.0)
    if img.dim() == 4:
        return img
    D, V, bh, bw, _ = img.shape
    return img.permute(0, 2, 3, 1, 4).reshape(D, bh, bw, V * 3)


def _per_view(fn, blocks):
    """Apply an RGB-image fn to blocks [D, bh, bw, 3] directly, or to
    channel-concatenated views [D, bh, bw, V*3] as one batch [D*V, bh, bw, 3]
    (view-major within a block)."""
    C = blocks.shape[-1]
    if C == 3:
        return fn(blocks)
    D, bh, bw, _ = blocks.shape
    V = C // 3
    x = blocks.reshape(D, bh, bw, V, 3).permute(0, 3, 1, 2, 4).reshape(D * V, bh, bw, 3)
    x = fn(x).reshape(D, V, bh, bw, 3)
    return x.permute(0, 2, 3, 1, 4).reshape(D, bh, bw, C)


def view_batch_shape(rays_shape):
    """The per-view batch shape [D*V, bh, bw, 3] of the blocks that ray
    bundles [D, bh, bw, 3] or [D, V, bh, bw, 3] render: the shape
    distortions and attacks see, and their draws take."""
    return (int(np.prod(rays_shape[:-3])), rays_shape[-3], rays_shape[-2], 3)


def _distort_and_normalize(blocks, kind, draws):
    """Distort and ImageNet-normalise each view (draws at
    ``view_batch_shape``)."""
    return _per_view(lambda x: normalize_img(distortion_layer(x, kind, draws)), blocks)


def _render_blocks(fp, grid, rays_o_b, rays_d_b, wcfg, rc, budget, plain=False):
    """Render the key blocks with the message: [D, bh, bw, 3] (or, with V
    key views, [D, bh, bw, V*3]) in [0, 1].  Misses take the frozen
    backbone's bg-sphere colour where it has one (``fp`` holds its leaves),
    as the pseudo-GT that ``model.render`` makes does."""
    out = render_rays_occ(lambda x, d: wtmk_field(fp, wcfg, x, d, plain=plain), grid,
                          rays_o_b.reshape(-1, 3), rays_d_b.reshape(-1, 3), rc,
                          budget=budget, bg_color=1.0, plain=plain,
                          bg_fn=background_fn(fp, wcfg.ngp, plain))
    return _blocks(out["image"], rays_o_b.shape)


def _wm_step_loss(backbone, tr, grid, rays_o_b, rays_d_b, ct_o, ct_d, ct_gt, message, draws,
                  lambda_w, lambda_i, wcfg, rc, budget, block_budget, distortion, loss_w_fn,
                  lambda_msg_reg=None, plain=False, patch_size=1, lambda_ssim=None):
    """The watermark training objective (ref ``utils_wtmk_disen.py:579-646``).

    Key blocks render at the extraction budget ``block_budget``, content
    rays at the pseudo-GT budget ``budget``; when the two are equal (the
    default) both render in ONE march + field + composite.  ``message`` is
    [D] int32 on the device, ``draws`` the distortion's random inputs at the
    per-view batch shape.  With ``patch_size > 1`` and ``lambda_ssim``, the
    content rays' leading patches add ``lambda_ssim * (1 - SSIM)``.
    Returns (loss, (lossw, lossi, decoded [D, 1]))."""
    fp = wtmk_field_params(backbone, tr, wcfg, message, plain)
    field = lambda x, d: wtmk_field(fp, wcfg, x, d, plain=plain)
    if budget == block_budget:
        n_b = rays_o_b.numel() // 3
        out = render_rays_occ(
            field, grid, torch.cat([rays_o_b.reshape(-1, 3), ct_o], 0),
            torch.cat([rays_d_b.reshape(-1, 3), ct_d], 0), rc, budget=block_budget,
            bg_color=1.0, plain=plain, bg_fn=background_fn(fp, wcfg.ngp, plain))
        blocks = _blocks(out["image"][:n_b], rays_o_b.shape)
        content_img = out["image"][n_b:]
    else:  # --wm_content_budget: two renders
        blocks = _render_blocks(fp, grid, rays_o_b, rays_d_b, wcfg, rc, block_budget, plain)
        content_img = render_rays_occ(field, grid, ct_o, ct_d, rc, budget=budget,
                                      bg_color=1.0, plain=plain,
                                      bg_fn=background_fn(fp, wcfg.ngp, plain))["image"]
    decoded = hidden_decoder_apply(tr["decoder"], wcfg.decoder,
                                   _distort_and_normalize(blocks, distortion, draws))
    lossw = loss_w_fn(decoded.reshape(-1), message.to(torch.float32).reshape(-1))
    lossi = torch.mean((content_img - ct_gt) ** 2)
    loss = lambda_w * lossw + lambda_i * lossi
    if patch_size > 1 and lambda_ssim is not None:
        loss = loss + lambda_ssim * (1.0 - patch_ssim(content_img, ct_gt, patch_size))
    if lambda_msg_reg is not None:
        loss = loss + lambda_msg_reg * torch.mean(torch.square(fp["msg_eff"]))
    return loss, (lossw, lossi, decoded)


class WatermarkTrainer:
    def __init__(self, name, opt, model: WatermarkModel, workspace="workspace",
                 metrics=None, metrics_message=None, eval_interval=10,
                 save_interval=10, max_keep_ckpt=2, use_checkpoint="latest",
                 mute=False):
        self.name = name
        self.opt = opt
        self.model = model
        self.workspace = workspace
        self.metrics = metrics if metrics is not None else [PSNRMeter(), SSIMMeter()]
        self.metrics_message = metrics_message if metrics_message is not None else [BitAccMeter()]
        self.eval_interval = eval_interval
        self.save_interval = save_interval
        self.max_keep_ckpt = max_keep_ckpt
        self.mute = mute
        _refuse_unported(opt)
        # the step's field config (JAX's wcfg_train): --hash_fwd_corners 1
        # makes the in-step block and content renders one-corner estimates;
        # every decode, test image and pseudo-GT keeps model.wcfg, exact
        self.wcfg_train = dataclasses.replace(model.wcfg,
                                              ngp=train_cfg(model.wcfg.ngp, opt))

        self.lambda_w = opt.lambda_w
        self.lambda_i = opt.lambda_i
        self.loss_kind = getattr(opt, "loss_w", "bce")
        self.loss_w_fn = make_loss_w(self.loss_kind)
        self.distortion = getattr(opt, "distortion", "none")
        self.message_dim = opt.message_dim
        # --wm_polish_iters: extra iterations after the main schedule with
        # lambda_w dropped to --wm_polish_lambda_w (content recovers, the
        # locked bit margins survive)
        self.polish_iters = int(getattr(opt, "wm_polish_iters", 0) or 0)
        self.total_iters = opt.iters + self.polish_iters
        self._polishing = False
        # content rays render at the pseudo-GT budget unless
        # --wm_content_budget says otherwise
        self.content_budget = getattr(opt, "wm_content_budget", 0) or model.infer_budget
        # --patch_size + --lambda_ssim: the structural content guard on
        # patch-shaped content rays
        self.patch_size = int(getattr(opt, "patch_size", 1) or 1)
        self.lambda_ssim = float(getattr(opt, "lambda_ssim", 0.0) or 0.0)
        if self.lambda_ssim > 0 and self.patch_size <= 1:
            raise ValueError("--lambda_ssim needs patch-structured content rays: "
                             "set --patch_size > 1 (num_rays divisible by patch_size**2)")
        self.lambda_msg_reg = float(getattr(opt, "lambda_msg_reg", 0.0) or 0.0)
        if self.lambda_msg_reg > 0 and "msg_tables" not in model.trainable:
            raise ValueError("--lambda_msg_reg regularises the codebook msg tables; this "
                             "model variant has no msg_tables in its trainable subtree")

        # --finetune_decoder: the message part takes no gradient and is not
        # in Adam (JAX zeroes its updates: the same tensors, bit for bit)
        self.finetune_decoder = model.wcfg.finetune_decoder
        self.opt_leaves = optimized_leaves(model.trainable, self.finetune_decoder)
        for p in trainable_leaves(model.trainable):
            p.requires_grad_(False)
        for p in self.opt_leaves:
            p.requires_grad_(True)
        self.lr_schedule = make_lr_schedule(opt.lr, opt.iters)
        self.optimizer = torch.optim.Adam(self.opt_leaves, lr=opt.lr, betas=(0.9, 0.99),
                                          eps=1e-15)
        self.epoch = 0
        self.global_step = 0
        self._wm_state_loaded = False
        self.stats = {"loss": [], "lossi": [], "lossw": [], "results": [],
                      "checkpoints": [], "best_result": None}
        self.rng = np.random.default_rng(opt.seed)
        # the device loop: lambda_w as a device scalar (the polish phase
        # changes it between dispatches), the device lr schedule (card),
        # the live CUDA graph of the step
        self.lambda_w_t = None
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

        # checkpoint resolution, ref utils_wtmk_disen.py:508-526
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
                except _CKPT_ERRORS as e:
                    self.log(f"[ckpt] {path} unreadable ({e}); falling back to previous")
        elif use_checkpoint and os.path.exists(use_checkpoint):
            self._load_or_resume(use_checkpoint)

    def _load_or_resume(self, use_checkpoint):
        """Crash-resume guard: a relaunch with its original flags names the
        clean backbone (outside this workspace) in --ckpt even when this
        workspace already holds watermark-stage progress; resume from the
        newest such checkpoint instead of retraining from step 0.  A path
        inside the workspace (a deliberate rewind) is honoured as given."""
        explicit_inside = (os.path.dirname(os.path.abspath(use_checkpoint))
                           == os.path.abspath(self.ckpt_path))
        if not explicit_inside:
            for path in checkpoint_candidates(self.ckpt_path, self.name):
                # peek at the raw dict first: a clean-stage candidate (same
                # ngp_ep*.ckpt names) must not apply its step or opt_state
                try:
                    raw = load_checkpoint(path)
                except _CKPT_ERRORS as e:
                    self.log(f"[ckpt] {path} unreadable ({e}); falling back to previous")
                    continue
                if not ("backbone" in raw and "trainable" in raw
                        and int(raw.get("global_step", 0)) > 0):
                    self.log(f"[ckpt] {path} holds no wm-stage progress (clean-format or "
                             "step 0) — not a resume candidate")
                    continue
                self.load_checkpoint(path)
                self.log(f"[ckpt] workspace already holds wm-stage progress (step "
                         f"{self.global_step}) — resumed from {path} instead of restarting "
                         f"from the backbone {use_checkpoint}")
                return
        self.load_checkpoint(use_checkpoint, model_only=True)

    # ------------------------------------------------------------------ util
    def log(self, *args):
        if not self.mute:
            print(*args, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as f:
                print(*args, file=f)

    def log_metrics(self, **scalars):
        if not self.workspace:
            return
        with open(os.path.join(self.workspace, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": self.global_step, **scalars}) + "\n")

    def random_message(self):
        return self.rng.integers(0, 2, self.message_dim).astype(np.int32)

    def opt_count(self):
        """Adam steps taken (optax's ``count``)."""
        state = self.optimizer.state.get(self.opt_leaves[0])
        return int(state["step"]) if state else 0

    # ----------------------------------------------------------------- train
    def _device_rays(self, wm):
        dev = self.model.device
        ro_b, rd_b = wm_rays(self.model.wcfg, wm)
        return (torch.as_tensor(np.asarray(ro_b, np.float32), device=dev),
                torch.as_tensor(np.asarray(rd_b, np.float32), device=dev))

    def _train_step(self, rays_o_b, rays_d_b, ct_o, ct_d, ct_gt, message, draws, rc,
                    plain=False, lambda_w=None):
        """One optimisation step with the given message ([D] int32 tensor)
        and distortion draws; ``lambda_w`` (default ``self.lambda_w``) may
        be a device scalar.  Returns (loss, lossw, lossi, decoded),
        detached."""
        m = self.model
        loss, (lossw, lossi, decoded) = _wm_step_loss(
            m.backbone, m.trainable, render_grid(m.occ, rc.t_cull), rays_o_b, rays_d_b,
            ct_o, ct_d, ct_gt, message, draws,
            self.lambda_w if lambda_w is None else lambda_w, self.lambda_i, self.wcfg_train,
            rc,
            self.content_budget, m.infer_budget, self.distortion, self.loss_w_fn,
            lambda_msg_reg=self.lambda_msg_reg or None, plain=plain,
            patch_size=self.patch_size, lambda_ssim=self.lambda_ssim or None)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(self.optimizer, self.opt_leaves[0], self.lr_schedule, self.device_schedule)
        self.optimizer.step()
        return loss.detach(), lossw.detach(), lossi.detach(), decoded.detach()

    def train_step_data(self, data, message):
        m = self.model
        dev = m.device
        ro_b, rd_b = self._device_rays(data["watermark"])
        ct = data["content"]
        ct_o = torch.as_tensor(np.asarray(ct["rays_o"], np.float32), device=dev).reshape(-1, 3)
        ct_d = torch.as_tensor(np.asarray(ct["rays_d"], np.float32), device=dev).reshape(-1, 3)
        ct_gt = torch.as_tensor(np.asarray(ct["images"], np.float32), device=dev).reshape(-1, 3)
        bits = torch.as_tensor(np.asarray(message, np.int32), device=dev)
        draws = distortion_draws(self.distortion, view_batch_shape(ro_b.shape), m.generator, dev)
        return self._train_step(ro_b, rd_b, ct_o, ct_d, ct_gt, bits, draws, m.rc)

    def train_one_epoch(self, loader):
        tot, totw, toti, n = 0.0, 0.0, 0.0, 0
        for data in loader:
            self._maybe_enter_polish(self.opt.iters)
            message = self.random_message()  # fresh per step, ref :1165
            loss, lossw, lossi, _ = self.train_step_data(data, message)
            # summed on the device: no host sync inside the epoch
            tot, totw, toti = tot + loss, totw + lossw, toti + lossi
            n += 1
            self.global_step += 1
            if self.global_step >= self.total_iters:
                break
        avg = [float(v) / max(n, 1) for v in (tot, totw, toti)]
        for k, v in zip(("loss", "lossw", "lossi"), avg):
            self.stats[k].append(v)
        self.log_metrics(loss=avg[0], lossw=avg[1], lossi=avg[2])
        return tuple(avg)

    def train(self, train_loader, test_image_loader=None, test_bitacc_loader=None,
              max_epochs=1):
        # the grid is the clean model's, frozen: only frustum-mark it
        if getattr(train_loader, "poses", None) is not None:
            self.model.mark_untrained_grid(train_loader.poses, train_loader.intrinsics)
        if self.workspace and getattr(train_loader, "images_block", None) is not None:
            self._save_gt_blocks(train_loader)
        start = time.time()
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            loss, lossw, lossi = self.train_one_epoch(train_loader)
            self.log(f"[wm epoch {epoch}/{max_epochs}] loss={loss:.6f} lossw={lossw:.6f} "
                     f"lossi={lossi:.6f} step={self.global_step} "
                     f"elapsed={time.time() - start:.1f}s")
            if test_bitacc_loader is not None and epoch % self.eval_interval == 0:
                self.test_bitacc(test_bitacc_loader)
            if test_image_loader is not None and epoch % self.eval_interval == 0:
                self.test_image(test_image_loader)
            if self.workspace and epoch % self.save_interval == 0:
                self.save_checkpoint(full=True)
                prune_checkpoints(self.ckpt_path, self.name, self.max_keep_ckpt)
            if self.global_step >= self.total_iters:
                break
        if self.workspace:
            self.save_checkpoint(full=True)

    def train_device(self, train_loader, max_steps=None, steps_per_dispatch=256,
                     test_image_loader=None, test_bitacc_loader=None):
        """On-device watermark training (``device_loop.wm_device_loop``):
        dispatches of K steps on the preloaded pseudo-GT pool and the static
        key-block bundles; a dispatch never straddles the polish boundary
        (its lambda_w is set at launch); between dispatches, every
        ``eval_interval`` of them ``test_bitacc`` and ``test_image``, every
        ``save_interval`` a checkpoint."""
        m = self.model
        max_steps = max_steps or self.opt.iters
        if getattr(train_loader, "poses", None) is not None:
            m.mark_untrained_grid(train_loader.poses, train_loader.intrinsics)
        if self.workspace and getattr(train_loader, "images_block", None) is not None:
            self._save_gt_blocks(train_loader)
        ro_b, rd_b = self._device_rays(next(iter(train_loader))["watermark"])
        data = preload(train_loader.poses, train_loader.train_images, train_loader.intrinsics,
                       train_loader.H, train_loader.W, m.device)
        rays_per_step = self.opt.num_rays + int(np.prod(ro_b.shape[:-1]))
        prepare_device_loop(self, self.opt_leaves)
        total = max_steps + self.polish_iters
        start = time.time()
        while self.global_step < total:
            self._maybe_enter_polish(max_steps)
            k = min(steps_per_dispatch, total - self.global_step)
            if self.polish_iters and not self._polishing and self.global_step < max_steps:
                k = min(k, max_steps - self.global_step)
            losses, lossws, lossis = wm_device_loop(self, data, ro_b, rd_b, k)
            self.global_step += k
            self.epoch += 1
            rays_s = k * rays_per_step / max(time.time() - start, 1e-9)
            self.log(f"[wm device loop] step={self.global_step}/{max_steps} "
                     f"loss={losses[-1]:.6f} lossw={lossws[-1]:.6f} lossi={lossis[-1]:.6f} "
                     f"({rays_s / 1e6:.2f}M rays/s)")
            for key, v in (("loss", losses), ("lossw", lossws), ("lossi", lossis)):
                self.stats[key].append(float(v.mean()))
            self.log_metrics(loss=float(losses.mean()), lossw=float(lossws.mean()),
                             lossi=float(lossis.mean()), rays_per_sec=rays_s)
            start = time.time()
            if test_bitacc_loader is not None and self.epoch % self.eval_interval == 0:
                self.test_bitacc(test_bitacc_loader)
            if test_image_loader is not None and self.epoch % self.eval_interval == 0:
                self.test_image(test_image_loader)
            if self.workspace and self.epoch % self.save_interval == 0:
                self.save_checkpoint(full=True)
                prune_checkpoints(self.ckpt_path, self.name, self.max_keep_ckpt)
        if self.workspace:
            self.save_checkpoint(full=True)

    def resolve_auto_compaction(self, loader):
        """``--compact_frac -1`` (and ``--group_budget -1``) in the wm stage:
        the backbone is frozen, so occupancy never changes; resolve both ONCE
        from a probe render of one view's rays at the train budget (the clean
        trainer's 1.3x-headroom 1/16 buckets and 1.5x-mean power-of-two
        group rule).  The probe's pixels come from a generator seeded with
        ``--seed``."""
        if getattr(self.opt, "compact_frac", 0) != -1:
            return
        m = self.model
        pose = np.asarray(loader.poses[:1], np.float32)
        rays = get_rays(pose, loader.intrinsics, loader.H, loader.W,
                        min(4096, loader.H * loader.W),
                        rng=np.random.default_rng(getattr(self.opt, "seed", 0)))
        m.render(rays["rays_o"][0], rays["rays_d"][0], None, staged=False,
                 budget=m.train_budget)
        n_occ = m._last_n_occupied.float()
        S = m.train_budget
        mean_occ = float(n_occ.mean())
        fill = min(mean_occ, S) / S
        target = min(1.0, math.ceil(1.3 * fill * 16.0) / 16.0)
        if target < 1.0:
            m.rc = dataclasses.replace(m.rc, compact_frac=target)
        self.log(f"[compact] wm auto sample compaction -> {target} "
                 f"(probe mean occupied {mean_occ:.1f}/{S})")
        if getattr(self.opt, "group_budget", 0) == -1:
            mean_g = float(m._last_n_groups_occ.float().mean())
            gb = 1 << max(4, int(np.ceil(np.log2(max(1.5 * mean_g, 1.0)))))
            gb = min(gb, max(num_candidates(m.rc.bound, m.rc.max_steps, m.rc.dt_gamma) // 4, 1))
            m.rc = dataclasses.replace(m.rc, group_budget=gb)
            self.log(f"[group] wm auto march group budget -> {gb} "
                     f"(probe mean occupied groups {mean_g:.1f})")

    def _maybe_enter_polish(self, main_iters):
        """Switch to the content-polish lambda once the main schedule ends."""
        if self.polish_iters and not self._polishing and self.global_step >= main_iters:
            self._polishing = True
            self.lambda_w = float(getattr(self.opt, "wm_polish_lambda_w", 0.0) or 0.0)
            self.log(f"[polish] entering {self.polish_iters}-iter content polish at "
                     f"lambda_w={self.lambda_w} (bits locked; recovering PSNR)")

    def _save_gt_blocks(self, loader):
        """Dump the GT key-block crops once (ref ``:766-789``)."""
        path = os.path.join(self.workspace, "gt_blocks")
        os.makedirs(path, exist_ok=True)
        for i, b in enumerate(np.asarray(loader.images_block)):
            write_png(os.path.join(path, f"block_{i:02d}.png"),
                      (np.clip(b, 0, 1) * 255).astype(np.uint8))

    # ------------------------------------------------------------------ eval
    def _rc_eval(self):
        """Block decodes run UNCOMPACTED and with the march pre-filter off:
        the compaction is sized from content rays (most miss), key blocks lie
        on textured surfaces, and the group budget can drop in-budget
        samples; decodes must be exact up to the sample budget only."""
        return dataclasses.replace(self.model.rc, compact_frac=0.0, prefilter=False,
                                   t_cull=0.0)

    @torch.no_grad()
    def _decode(self, ro_b, rd_b, message, distortion):
        m = self.model
        bits = torch.as_tensor(np.asarray(message, np.int32), device=m.device)
        fp = wtmk_field_params(m.backbone, m.trainable, m.wcfg, bits)
        blocks = _render_blocks(fp, m.occ.occupancy, ro_b, rd_b, m.wcfg, self._rc_eval(),
                                m.infer_budget)
        draws = distortion_draws(distortion, view_batch_shape(ro_b.shape), m.generator,
                                 m.device)
        decoded = hidden_decoder_apply(m.trainable["decoder"], m.wcfg.decoder,
                                       _distort_and_normalize(blocks, distortion, draws))
        return blocks, decoded

    def eval_blocks(self, wm, message, distortion=None):
        ro_b, rd_b = self._device_rays(wm)
        blocks, decoded = self._decode(ro_b, rd_b, message, distortion or self.distortion)
        return blocks.cpu().numpy(), decoded.cpu().numpy()

    def test_bitacc(self, loader, record_path=None, batch=None, save_best=True):
        """Random messages -> sign-agreement bit accuracy and its p-value
        (ref ``test_bitacc`` / ``test_bitacc_record``, ``:935-1085``).

        A score above the best so far saves the best checkpoint; a
        verification of weights that are not the model's own (an attack's)
        passes ``save_best=False`` so that they never take its place.

        Each message renders and decodes on its own, so the decoder's batch
        statistics are per message, as in JAX's message-vmapped decode.
        Messages are drawn ``--bitacc_batch`` at a time, the tail padded
        with unused draws, as JAX draws them: the same seed gives the same
        messages in both packages."""
        meter = self.metrics_message[0]
        meter.clear()
        batch = batch or getattr(self.opt, "bitacc_batch", 8)
        n_trials = len(loader)
        wm = next(iter(loader), {}).get("watermark")
        if wm is None:
            return None
        ro_b, rd_b = self._device_rays(wm)
        done = 0
        t0 = time.time()
        self.log(f"[test_bitacc] evaluating {n_trials} messages")
        while done < n_trials:
            use = min(batch, n_trials - done)
            messages = [self.random_message() for _ in range(batch)]
            for message in messages[:use]:
                _, decoded = self._decode(ro_b, rd_b, message, self.distortion)
                meter.update(decoded.cpu().numpy().reshape(-1), message)
            done += use
        self.bitacc_seconds = time.time() - t0
        acc = meter.measure()
        self.log(f"[test_bitacc] {meter.report()} over {meter.N} messages (ownership "
                 f"evidence vs random guessing: {meter.significance()}; "
                 f"{self.bitacc_seconds / max(n_trials, 1):.4f} s a message)")
        if record_path or (self.workspace and record_path is None):
            path = record_path or os.path.join(self.workspace, "bitacc.txt")
            with open(path, "a") as f:
                for r in meter.records:
                    f.write(f"{r}\n")
        if save_best and acc is not None and (self.stats["best_result"] is None
                                              or acc > self.stats["best_result"]):
            self.stats["best_result"] = acc
            if self.workspace:
                self.save_checkpoint(best=True)
        return acc

    def test_image(self, loader, name="test_image"):
        """Whole-image renders with a random message against the pseudo-GT
        (ref ``test_image``, ``:816-933``); PNGs in the workspace."""
        for metric in self.metrics:
            metric.clear()
        m = self.model
        save_path = os.path.join(self.workspace, name) if self.workspace else None
        if save_path:
            os.makedirs(save_path, exist_ok=True)
        for i, data in enumerate(loader):
            message = self.random_message()
            out = m.render(data["rays_o"], data["rays_d"], message, staged=True,
                           max_ray_batch=getattr(self.opt, "max_ray_batch", 4096))
            H, W = data["H"], data["W"]
            pred = np.clip(out["image"].cpu().numpy().reshape(-1, H, W, 3), 0, 1)
            gt = np.asarray(data["images"]).reshape(-1, H, W, 3)
            for metric in self.metrics:
                metric.update(pred, gt)
            if save_path:
                write_png(os.path.join(save_path, f"{i:04d}_rgb.png"),
                          (pred[0] * 255).astype(np.uint8))
        for metric in self.metrics:
            self.log(f"[{name}] {metric.report()}")
        return {m_.name: m_.measure() for m_ in self.metrics}

    # ------------------------------------------------------------ checkpoint
    def _opt_state(self):
        """Adam's state in optax's layout (zeros before the first step);
        under ``--finetune_decoder`` in ``multi_transform``'s."""
        tr = self.model.trainable
        trained = {"decoder": tr["decoder"]} if self.finetune_decoder else tr

        def moment(key):
            def leaf(p):
                st = self.optimizer.state.get(p)
                return st[key] if st else torch.zeros_like(p)
            return _tree_map(leaf, trained)

        mu, nu = moment("exp_avg"), moment("exp_avg_sq")
        if self.finetune_decoder:
            return masked_opt_state_to_jax(self.opt_count(), mu, nu,
                                           [k for k in tr if k != "decoder"])
        return opt_state_to_jax(self.opt_count(), mu, nu, trainable_to_jax)

    def _load_opt_state(self, state_dict):
        if self.finetune_decoder:
            count, mu, nu = masked_opt_state_from_jax(state_dict, self.model.device)
        else:
            count, mu, nu = opt_state_from_jax(state_dict, self.model.device, trainable_from_jax)
        leaves = self.opt_leaves
        mu, nu = (optimized_leaves(t, self.finetune_decoder) for t in (mu, nu))
        if len(mu) != len(leaves) or len(nu) != len(leaves):
            raise ValueError(f"optimizer state holds {len(mu)} leaves, the model trains "
                             f"{len(leaves)}")
        for p, a, b in zip(leaves, mu, nu):
            if a.shape != p.shape or b.shape != p.shape:
                raise ValueError(f"optimizer moment shape {tuple(a.shape)} vs {tuple(p.shape)}")
        for p, a, b in zip(leaves, mu, nu):
            self.optimizer.state[p] = {"step": adam_step(self.optimizer, count, p.device),
                                       "exp_avg": a, "exp_avg_sq": b}

    def _state(self, full=True):
        state = {
            "backbone": to_state_dict(self.model.backbone),
            "trainable": trainable_to_jax(self.model.trainable),
            "occ": self.model.occ,
            "epoch": self.epoch,
            "global_step": self.global_step,
        }
        if full:
            state["opt_state"] = self._opt_state()
        return state

    def save_checkpoint(self, full=True, best=False):
        """The JAX package's watermark checkpoint (the best one drops the
        grid and the optimizer state)."""
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
        """A watermark checkpoint of either package, or a CLEAN one whose
        params become the frozen backbone (msg tables and decoder keep their
        init), ref ``:1474-1479``."""
        raw = load_checkpoint(path)
        m = self.model
        drop_graph(self)
        backbone = raw.get("backbone", raw.get("params"))
        if backbone is None:
            raise KeyError(f"{path} holds neither 'backbone' nor 'params'")
        backbone = params_from_jax(backbone, m.device)
        check_params_like(m.backbone, backbone)
        if "backbone" in raw and "trainable" in raw:
            tr = trainable_from_jax(raw["trainable"], m.device)
            if set(tr) != set(m.trainable):
                raise ValueError(f"checkpoint trainable holds {sorted(tr)}, the model "
                                 f"{sorted(m.trainable)} (--copyrnerf differs?)")
            pairs = list(zip(trainable_leaves(m.trainable), trainable_leaves(tr)))
            for a, b in pairs:
                if a.shape != b.shape:
                    raise ValueError(f"checkpoint trainable shape {tuple(b.shape)} vs model "
                                     f"{tuple(a.shape)} (message_dim or table size differ?)")
            with torch.no_grad():
                for a, b in pairs:
                    a.copy_(b)
            self._wm_state_loaded = True
        m.backbone = backbone
        if "occ" in raw:
            restore_occupancy(m, raw["occ"])
        if not model_only:
            self.epoch = int(raw.get("epoch", 0))
            self.global_step = int(raw.get("global_step", 0))
            if "opt_state" in raw:
                try:
                    self._load_opt_state(raw["opt_state"])
                except (KeyError, ValueError, TypeError) as e:
                    self.log(f"[ckpt] optimizer restore failed (soft): {e}")
        self.log(f"[ckpt] loaded {path}")
        ensure_occupancy(m, path, self.log)


def _refuse_unported(opt):
    """Raise on the watermark-stage options the port does not run yet."""
    if getattr(opt, "devices", 0) > 1:
        raise NotImplementedError("not ported yet: --devices > 1 (ROADMAP queue 1: "
                                  "--devices > 1)")
