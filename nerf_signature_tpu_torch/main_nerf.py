"""Clean-stage CLI of the port: the twin of the repo's ``main_nerf.py``
(same flags), training and ``--test``.

    python -m nerf_signature_tpu_torch.main_nerf <scene> -O \\
        --bound 1.0 --scale 0.8 --dt_gamma 0            # train
    python -m nerf_signature_tpu_torch.main_nerf <scene> -O --test \\
        --bound 1.0 --scale 0.8 --dt_gamma 0            # evaluate, render, mesh

runs on the CUDA GPU; ``--cpu`` runs the plain PyTorch versions on the CPU.
Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``--steps_per_dispatch``, ``--error_map``, ``--patch_size`` with
LPIPS/SSIM, ``--clip_text``, ``--stochastic_hash_grad``, ``--bg_radius > 0``,
``--devices > 1``, ``--t_cull > 0``; ``--gui`` and ``--prewatermark`` exit 2.
"""

import argparse
import sys

import numpy as np
import torch

from .utils.config import add_common_args, apply_O_macro


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    opt = apply_O_macro(parser.parse_args(argv))
    print(opt)
    for flag in ("gui", "prewatermark"):
        if getattr(opt, flag):
            print(f"nerf_signature_tpu_torch: --{flag} is not ported yet",
                  file=sys.stderr)
            return 2
    if not opt.test and opt.steps_per_dispatch > 0:
        raise NotImplementedError(
            "--steps_per_dispatch (the on-device K-step loop) is ROADMAP queue 1 "
            "item 'device loop / CUDA graph of the step', not ported yet")

    from .api import NGPModel
    from .data.provider import NeRFDataset
    from .meshing.extract import save_mesh
    from .models.ngp import NGPConfig
    from .train.metrics import LPIPSMeter, PSNRMeter
    from .train.trainer import T_CULL_TODO, Trainer

    if not opt.test and opt.t_cull > 0:
        raise NotImplementedError(T_CULL_TODO)
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
        train_loader = NeRFDataset(opt, type="train").dataloader()
        valid_loader = NeRFDataset(opt, type="val", downscale=1).dataloader()
        trainer = Trainer("ngp", opt, model, workspace=opt.workspace, ema_decay=0.95,
                          metrics=metrics, use_checkpoint=opt.ckpt, eval_interval=50)
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
        trainer.test(test_loader, write_video=True)
    save_mesh(model, mesh_path, resolution=opt.mesh_resolution, threshold=10)
    trainer.log(f"[mesh] wrote {mesh_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
