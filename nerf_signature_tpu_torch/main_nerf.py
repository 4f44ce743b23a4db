"""Clean-stage CLI of the port, serving half: the twin of the repo's
``main_nerf.py --test`` (same flags).

    python -m nerf_signature_tpu_torch.main_nerf <scene> -O --test \\
        --bound 1.0 --scale 0.8 --dt_gamma 0

runs on the CUDA GPU; ``--cpu`` runs the plain PyTorch versions on the CPU.
Training (no ``--test``) lands with the next slice and exits non-zero.
"""

import argparse
import sys

import torch

from .utils.config import add_common_args, apply_O_macro


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    opt = apply_O_macro(parser.parse_args(argv))
    print(opt)
    if not opt.test:
        print("nerf_signature_tpu_torch: only --test (serving) is ported; "
              "training lands with the next slice (ROADMAP slice 2)",
              file=sys.stderr)
        return 2
    for flag in ("gui", "prewatermark"):
        if getattr(opt, flag):
            print(f"nerf_signature_tpu_torch: --{flag} is not ported yet",
                  file=sys.stderr)
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
