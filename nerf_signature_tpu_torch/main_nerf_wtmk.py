"""Watermark-stage CLI of the port: the twin of the repo's
``main_nerf_wtmk.py`` (same flags).  Embeds a codebook message into a frozen
clean model and trains the HiDDeN bit extractor; ``--test`` verifies
ownership (bit accuracy and its p-value over ``--n_test_bitacc`` random
messages), runs the attack suites it is asked for (``--attack_suite``: the
13-attack sweep; ``--adv_attack``: the epsilon-ball parameter attack;
``--finetune_attack [--finetune_attack_full]``: the backbone finetuning
attack; bit accuracy again after each, with the original weights put back
afterwards) and renders test images against the pseudo-GT.

    python -m nerf_signature_tpu_torch.main_nerf_wtmk <scene> -O --wtmk_tcnn \\
        --workspace ws_wm --ckpt ws/checkpoints/ngp_ep0300.ckpt \\
        --message_dim 32 --lambda_w 0.005 --lambda_i 1.0 --loss_w bce \\
        --iters 1000 --num_rows 32 --num_cols 32 --downscale 2 \\
        --bound 1.0 --scale 0.8 --dt_gamma 0                 # embed
    python -m nerf_signature_tpu_torch.main_nerf_wtmk ... --ckpt latest --test

runs on the CUDA GPU; ``--cpu`` runs the plain PyTorch versions on the CPU.
``--steps_per_dispatch K`` trains K steps a dispatch on the device
(``WatermarkTrainer.train_device``: on the card a replayed CUDA graph of the
step).  Checkpoints are the JAX package's format both ways.  ``--t_cull``,
``--patch_size N --lambda_ssim w`` and ``--stochastic_hash_grad
[--hash_fwd_corners 1]`` (K7, the step's backbone encode) train on both
paths; a backbone trained with ``--bg_radius R`` renders its background
sphere (K8) in every watermark render.  The paper's baselines run on both
paths too: ``--copyrnerf [--copyrnerf_replace]`` (the colour-space MLP, K10,
whole-image extraction), ``--whole_image_wm`` (the codebook tables with
whole-image extraction) and ``--finetune_decoder`` (only the decoder
trains).  Not ported yet (it raises ``NotImplementedError`` naming its
ROADMAP item): ``--devices > 1``.
"""

import argparse
import os
import sys

import numpy as np
import torch

from .utils.config import add_common_args, add_wtmk_args, apply_O_macro

def parse(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    add_wtmk_args(parser)
    return apply_O_macro(parser.parse_args(argv))


def setup(opt):
    """The watermark model, its trainer (checkpoint resolved) and the loader
    factory ``make_loader(type, n_views, n_test, fresh_keys=False)``, as the
    CLI builds them from ``opt``."""
    from .api import WatermarkModel
    from .data.provider_wtmk import NeRFDatasetDisen
    from .models.ngp import NGPConfig
    from .models.watermark import WatermarkConfig
    from .train.metrics import BitAccMeter, LPIPSMeter, PSNRMeter, SSIMMeter
    from .train.trainer_wtmk import WatermarkTrainer

    wcfg = WatermarkConfig(
        ngp=NGPConfig(
            bound=opt.bound,
            compute_dtype=torch.bfloat16 if opt.fp16 else torch.float32,
            bg_radius=opt.bg_radius,
            stochastic_hash_grad=opt.stochastic_hash_grad,
            hash_level_stride=opt.hash_level_stride,
            dense_coarse=opt.dense_coarse,
            n_levels=opt.n_levels,
            n_features=opt.n_features,
        ),
        message_dim=opt.message_dim,
        n_views=opt.n_views,
        hash_select=opt.hash_select,
        whole_image=opt.whole_image_wm,
        copyrnerf=opt.copyrnerf,
        copyrnerf_replace=opt.copyrnerf_replace,
        finetune_decoder=opt.finetune_decoder,
    )
    model = WatermarkModel(
        wcfg, cuda_ray=opt.cuda_ray, min_near=opt.min_near,
        density_thresh=opt.density_thresh, bg_radius=opt.bg_radius,
        dt_gamma=opt.dt_gamma, max_steps=opt.max_steps, grid_size=opt.grid_size,
        seed=opt.seed, train_budget=opt.train_budget, infer_budget=opt.infer_budget,
        compact_frac=max(0.0, opt.compact_frac), t_cull=opt.t_cull,
        device="cpu" if opt.cpu else None,
    )
    trainer = WatermarkTrainer(
        "ngp", opt, model, workspace=opt.workspace,
        metrics=[PSNRMeter(), LPIPSMeter(weights_path=opt.lpips_weights, device=model.device),
                 SSIMMeter()],
        metrics_message=[BitAccMeter()], eval_interval=opt.eval_interval,
        save_interval=opt.save_interval, use_checkpoint=opt.ckpt,
    )

    keyposes = os.path.join(opt.workspace, "key_poses.npy")
    keyblocks = os.path.join(opt.workspace, "key_blocks.npy")
    # the pseudo-GT pool is cached in the workspace (fingerprinted: a changed
    # backbone or pose set re-renders it)
    if opt.pseudo_gt_cache is None and opt.workspace:
        os.makedirs(opt.workspace, exist_ok=True)
        opt.pseudo_gt_cache = os.path.join(opt.workspace, "pseudo_gt.npz")

    def make_loader(type, n_views, n_test, fresh_keys=False):
        return NeRFDatasetDisen(
            opt,
            keyposes_dir=None if fresh_keys else keyposes,
            keyposes_save_dir=keyposes if fresh_keys else None,
            keyblocks_dir=None if fresh_keys else keyblocks,
            keyblocks_save_dir=keyblocks if fresh_keys else None,
            pretrained_model=model, downscale=opt.downscale, type=type,
            n_views=n_views, n_test=n_test, message_dim=opt.message_dim,
            num_rows=opt.num_rows, num_cols=opt.num_cols,
            use_existset=opt.use_existset,
        ).dataloader()

    return model, trainer, make_loader


def run_attacks(opt, model, trainer, make_loader):
    """The attack suites of ``--test``, as the repo's ``main_nerf_wtmk.py``
    runs them: the sweep, then the parameter-space attacks on one shared
    train loader, each followed by ``test_bitacc`` on the attacked weights
    (and, after the finetuning attack, the test images); the original
    weights are put back after each.  The attacked weights' verification
    saves no best checkpoint, whatever it scores."""
    from .train.attack import attack_sweep, finetune_attack, parameter_attack

    if opt.attack_suite:
        attack_sweep(trainer, make_loader("test", opt.n_views, opt.n_test_attack),
                     n_test=opt.n_test_attack)
    if not (opt.adv_attack or opt.finetune_attack):
        return
    attack_loader = make_loader("train", opt.n_views, 100)
    if opt.adv_attack:
        attacked = parameter_attack(trainer, attack_loader, epsilon=opt.adv_epsilon,
                                    steps=opt.adv_steps, num_rays=opt.num_rays)
        original, model.trainable = model.trainable, attacked
        try:
            trainer.log("[adv_attack] bit accuracy AFTER epsilon-ball attack:")
            trainer.test_bitacc(make_loader("test", opt.n_views, opt.n_test_bitacc),
                                save_best=False)
        finally:
            model.trainable = original
    if opt.finetune_attack:
        attacked_bb = finetune_attack(trainer, attack_loader, steps=opt.finetune_attack_steps,
                                      lr=opt.finetune_attack_lr, num_rays=opt.num_rays,
                                      full_backbone=opt.finetune_attack_full)
        original_bb, model.backbone = model.backbone, attacked_bb
        try:
            trainer.log("[finetune_attack] bit accuracy AFTER backbone finetuning attack:")
            trainer.test_bitacc(make_loader("test", opt.n_views, opt.n_test_bitacc),
                                save_best=False)
            if opt.num_images_test > 0:
                trainer.test_image(make_loader("test_image", opt.num_images_test, 4),
                                   name="test_image_after_finetune_attack")
        finally:
            model.backbone = original_bb


def main(argv=None):
    opt = parse(argv)
    print(opt)
    model, trainer, make_loader = setup(opt)
    if opt.test:
        if not trainer._wm_state_loaded:
            print("[warn] test mode with a freshly-initialised watermark state (the --ckpt "
                  "file held no msg/decoder weights): bit accuracy will be ~0.5. Use "
                  "--ckpt latest (or point --ckpt at a watermark-stage checkpoint).",
                  flush=True)
        trainer.test_bitacc(make_loader("test", opt.n_views, opt.n_test_bitacc))
        run_attacks(opt, model, trainer, make_loader)
        if opt.num_images_test > 0:
            trainer.test_image(make_loader("test_image", opt.num_images_test, 4),
                               name="test_image_from_randomviews")
            trainer.test_image(make_loader("test_image_testviews", opt.num_images_test, 4),
                               name="test_image_from_testviews")
        return 0
    fresh = not os.path.exists(os.path.join(opt.workspace, "key_poses.npy"))
    train_loader = make_loader("train", opt.n_views, 100, fresh_keys=fresh)
    # --compact_frac -1: occupancy is frozen in the wm stage, so auto mode
    # resolves once from a probe render
    trainer.resolve_auto_compaction(train_loader)
    test_bitacc_loader = make_loader("test", opt.n_views, opt.n_test_bitacc)
    test_image_loader = make_loader("test_image", opt.num_images_test, 4)
    if opt.steps_per_dispatch > 0:
        trainer.train_device(train_loader, opt.iters, steps_per_dispatch=opt.steps_per_dispatch,
                             test_image_loader=test_image_loader,
                             test_bitacc_loader=test_bitacc_loader)
    else:
        total = opt.iters + opt.wm_polish_iters
        trainer.train(train_loader, test_image_loader, test_bitacc_loader,
                      int(np.ceil(total / len(train_loader))))
    trainer.test_image(make_loader("test_image_testviews", opt.num_images_test, 4),
                       name="test_image_from_testviews")
    return 0


if __name__ == "__main__":
    sys.exit(main())
