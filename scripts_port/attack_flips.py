#!/usr/bin/env python3
"""Read how an attack step through the kernels differs from one through the
plain versions (``chip_smoke.py:attack_step_errors``) on watermark models
trained as ``chip_smoke.py`` trains its own (its train phase's backbone,
then 1000 watermark steps), on one NVIDIA GPU.  Per model: the parameter
attack's step after 20 steps of it, on --batches messages, and the
finetuning attack's, the hash table alone and every backbone leaf, each
after 36 steps of it, on --batches train batches of 4096 rays.  Per step:
the whole loss's relative error, the rays where the two routes part (a
sample's sigma or colour not equal, or a sample composited by one route
only) and their largest colour difference, the loss over the other rays,
and the worst leaf's gradient rel L2.  One JSON line a step to --out, then
a summary by attack against ``chip_smoke.py``'s limits.

    python3 scripts_port/attack_flips.py [--models 3] [--batches 24] [--out FILE]
"""

import argparse
import gc
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PARAM_STEPS = 20      # parameter-attack steps before the readings
FINETUNE_STEPS = 36   # finetuning-attack steps before the readings


def batches(loader):
    """The loader's batches, round and round."""
    while True:
        yield from loader


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", type=int, default=3)
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attack_flips: no CUDA GPU visible; this script runs on the card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nerf_signature_tpu_torch.train import attack as t_atk

    dev = torch.device("cuda")
    print(cs.phase_device(), flush=True)
    cs.phase_build()
    out = open(args.out, "w") if args.out else None
    rows = []

    def read(model, kind, i, loss, leaves):
        e = dict(cs.attack_step_errors(loss, leaves), model=model, attack=kind, step=i)
        rows.append(e)
        if out:
            out.write(json.dumps(e) + "\n")
            out.flush()

    for model in range(args.models):
        backbone = cs.phase_train(dev).pop("model")
        with tempfile.TemporaryDirectory() as d:
            w = cs.wm_train(dev, backbone, d)
            trainer, loader = w["trainer"], w["loader"]
            atk = t_atk.ParameterAttack(trainer, loader, cs.ADV_EPSILON, num_rays=cs.TRAIN_RAYS)
            rng = np.random.default_rng(model)
            msg = lambda: rng.integers(0, 2, cs.WM_BITS).astype(np.int32)
            for _ in range(PARAM_STEPS):
                atk.step(msg())
            for i in range(args.batches):
                bits = torch.as_tensor(msg(), device=dev)
                read(model, "parameter", i, lambda plain: atk.loss(bits, plain), atk.leaves[:1])
            for full in (False, True):
                kind = "finetune_full" if full else "finetune"
                atk = t_atk.FinetuneAttack(trainer, num_rays=cs.TRAIN_RAYS, full_backbone=full)
                data = batches(loader)
                for _ in range(FINETUNE_STEPS):
                    atk.step(next(data))
                data = batches(loader)
                for i in range(args.batches):
                    ro, rd, tg = t_atk._content(next(data), cs.TRAIN_RAYS, dev)
                    read(model, kind, i, lambda plain: atk.loss(ro, rd, tg, plain),
                         t_atk._leaves(atk.train_part))
            del w, trainer, loader, atk
        del backbone
        gc.collect()
        print(f"model {model}: {len(rows)} steps read", flush=True)

    summary = {}
    for kind in ("parameter", "finetune", "finetune_full"):
        r = [e for e in rows if e["attack"] == kind]
        over = lambda e: (e["loss_rel"] > cs.TRAINED_LOSS_LIM or e["worst_rel_l2"] > 5e-3
                          or e["rays_apart"] > cs.FLIP_RAY_SHARE * e["rays"]
                          or e["rays_apart_max_abs"] > cs.FLIP_RAY_LIM)
        summary[kind] = {
            "steps": len(r),
            "loss_rel_all_max": max(e["loss_rel_all"] for e in r),
            "loss_rel_all_over_limit": sum(e["loss_rel_all"] > cs.TRAINED_LOSS_LIM for e in r),
            "loss_rel_other_rays_max": max(e["loss_rel"] for e in r),
            "rays_apart_max": max(e["rays_apart"] for e in r),
            "rays_apart_mean": sum(e["rays_apart"] for e in r) / len(r),
            "samples_apart_max": max(e["samples_apart"] for e in r),
            "rays_apart_max_abs": max(e["rays_apart_max_abs"] for e in r),
            "worst_rel_l2_max": max(e["worst_rel_l2"] for e in r),
            "steps_failing_check_attack_step": sum(map(over, r)),
        }
    print(json.dumps({"limits": {"loss_rel": cs.TRAINED_LOSS_LIM, "rays_apart_share":
                                 cs.FLIP_RAY_SHARE, "rays_apart_max_abs": cs.FLIP_RAY_LIM},
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
