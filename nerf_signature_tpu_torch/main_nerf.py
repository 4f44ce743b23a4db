"""Clean-stage CLI of the port: the twin of the repo's ``main_nerf.py``
(same flags), training and ``--test``.

    python -m nerf_signature_tpu_torch.main_nerf <scene> -O \\
        --bound 1.0 --scale 0.8 --dt_gamma 0            # train
    python -m nerf_signature_tpu_torch.main_nerf <scene> -O --test \\
        --bound 1.0 --scale 0.8 --dt_gamma 0            # evaluate, render, mesh

runs on the CUDA GPU; ``--cpu`` runs the plain PyTorch versions on the CPU.
``--steps_per_dispatch K`` trains K steps a dispatch on the device
(``Trainer.train_device``: on the card a replayed CUDA graph of the step,
on the CPU the same step eagerly).  ``--t_cull``, ``--error_map`` and
``--patch_size N --lambda_ssim w`` run on both paths (``--lambda_ssim`` with
``--error_map`` only per step, as in JAX), and so do the stochastic hash
estimators (``--stochastic_hash_grad [--hash_level_stride N]
[--hash_fwd_corners 1]``, K7, in the train step only) and the bg-sphere
model (``--bg_radius R``, K8).  ``--prewatermark`` is the paper's
2D-watermark-then-train baseline (``train/prewatermark.py``): training first
pretrains a HiDDeN encoder/decoder pair on the train images, embeds one
owner message into them (RGBA composited over white first) and writes
``<workspace>/prewatermark.ckpt`` in the JAX package's keys; ``--test
--prewatermark`` decodes the message from the rendered test views and
reports the bit survival.  Either package reads the other's file.
Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``--patch_size`` with LPIPS weights, ``--clip_text``, ``--devices >
1``; ``--gui`` exits 2.
"""

import argparse
import os
import sys

import numpy as np
import torch

from .utils.config import add_common_args, apply_O_macro


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    # the clean stage's SSIM patch guard (the JAX package's Trainer reads the
    # option, its clean CLI only the watermark CLI's flag of the same name)
    parser.add_argument("--lambda_ssim", type=float, default=0.0,
                        help="add lambda_ssim * (1 - SSIM) over the batch's "
                             "--patch_size patches (requires --patch_size > 1)")
    opt = apply_O_macro(parser.parse_args(argv))
    print(opt)
    if opt.gui:
        print("nerf_signature_tpu_torch: --gui is not ported yet", file=sys.stderr)
        return 2
    from .api import NGPModel
    from .data.provider import NeRFDataset
    from .meshing.extract import save_mesh
    from .models.ngp import NGPConfig
    from .train.metrics import LPIPSMeter, PSNRMeter
    from .train.trainer import Trainer

    device = "cpu" if opt.cpu else None
    cfg = NGPConfig(
        bound=opt.bound,
        compute_dtype=torch.bfloat16 if opt.fp16 else torch.float32,
        bg_radius=opt.bg_radius,
        stochastic_hash_grad=opt.stochastic_hash_grad,
        hash_level_stride=opt.hash_level_stride,
        dense_coarse=opt.dense_coarse,
        n_levels=opt.n_levels,
        n_features=opt.n_features,
    )
    model = NGPModel(
        cfg, cuda_ray=opt.cuda_ray, min_near=opt.min_near,
        density_thresh=opt.density_thresh, bg_radius=opt.bg_radius,
        dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
        grid_size=opt.grid_size, seed=opt.seed,
        train_budget=opt.train_budget, infer_budget=opt.infer_budget,
        compact_frac=max(0.0, opt.compact_frac), t_cull=opt.t_cull,
        num_steps=opt.num_steps, upsample_steps=opt.upsample_steps,
        device=device,
    )
    metrics = [PSNRMeter(), LPIPSMeter(weights_path=opt.lpips_weights)]
    if not opt.test:
        train_set = NeRFDataset(opt, type="train")
        if opt.prewatermark:
            prewatermark_train_set(opt, train_set, model.device)
        train_loader = train_set.dataloader()
        valid_loader = NeRFDataset(opt, type="val", downscale=1).dataloader()
        trainer = Trainer("ngp", opt, model, workspace=opt.workspace, ema_decay=0.95,
                          metrics=metrics, use_checkpoint=opt.ckpt, eval_interval=50)
        if opt.steps_per_dispatch > 0:
            trainer.train_device(train_loader, opt.iters,
                                 steps_per_dispatch=opt.steps_per_dispatch)
        else:
            max_epoch = int(np.ceil(opt.iters / len(train_loader)))
            trainer.train(train_loader, valid_loader, max_epoch)
        trainer.evaluate_one_epoch(valid_loader)
        return 0
    trainer = Trainer("ngp", opt, model, workspace=opt.workspace,
                      metrics=metrics, use_checkpoint=opt.ckpt)
    mesh_path = f"{opt.workspace}/mesh.ply"
    if not opt.mesh_only:
        test_loader = NeRFDataset(opt, type="test").dataloader()
        if test_loader.has_gt:
            trainer.evaluate_one_epoch(test_loader)
        frames = trainer.test(test_loader, write_video=True)
        if opt.prewatermark:
            acc, per_view = prewatermark_survival(opt, frames, model.device)
            trainer.log(f"[prewatermark] bit survival over {len(per_view)} rendered views: "
                        f"{acc:.4f}")
    save_mesh(model, mesh_path, resolution=opt.mesh_resolution, threshold=10)
    trainer.log(f"[mesh] wrote {mesh_path}")
    return 0


def prewatermark_train_set(opt, train_set, device):
    """--prewatermark before training: pretrain the HiDDeN pair on the train
    images, replace them by their watermarked copies (composited over white
    first: the trainer's RGBA ground truth would otherwise wash the mark out
    where alpha < 1) and write ``prewatermark.ckpt``."""
    from .train.checkpoint import conv_tree_to_jax, save_checkpoint
    from .train.prewatermark import pretrain_hidden, watermark_images

    message = np.random.default_rng(opt.seed).integers(0, 2, opt.prewatermark_bits)
    imgs = train_set.images.astype(np.float32)
    if imgs.shape[-1] == 4:
        imgs = imgs[..., :3] * imgs[..., 3:] + (1.0 - imgs[..., 3:])
    enc, dec, enc_cfg, dec_cfg = pretrain_hidden(
        imgs, opt.prewatermark_bits, steps=opt.prewatermark_steps,
        strength=opt.prewatermark_strength, seed=opt.seed, device=device)
    train_set.images = watermark_images(enc, enc_cfg, imgs, message,
                                        strength=opt.prewatermark_strength)
    os.makedirs(opt.workspace, exist_ok=True)
    save_checkpoint(os.path.join(opt.workspace, "prewatermark.ckpt"),
                    {"decoder": conv_tree_to_jax(dec), "encoder": conv_tree_to_jax(enc),
                     "message": message, "dec_blocks": dec_cfg.num_blocks,
                     "channels": dec_cfg.channels, "num_bits": dec_cfg.num_bits})


def prewatermark_survival(opt, frames, device):
    """--test --prewatermark: the owner message's bit accuracy over the
    rendered views (uint8 frames), decoded with ``prewatermark.ckpt``."""
    from .models.hidden import HiddenDecoderSingleConfig
    from .train.checkpoint import conv_tree_from_jax, load_checkpoint
    from .train.prewatermark import bit_survival

    art = load_checkpoint(os.path.join(opt.workspace, "prewatermark.ckpt"))
    dec_cfg = HiddenDecoderSingleConfig(
        num_blocks=int(art.get("dec_blocks", 8)),
        num_bits=int(art.get("num_bits", opt.prewatermark_bits)),
        channels=int(art.get("channels", 64)))
    dec = conv_tree_from_jax(art["decoder"], device)
    renders = np.stack(frames).astype(np.float32) / 255.0
    return bit_survival(dec, dec_cfg, renders, art["message"])


if __name__ == "__main__":
    sys.exit(main())
