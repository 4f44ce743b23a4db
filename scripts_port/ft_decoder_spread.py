#!/usr/bin/env python3
"""Read how far ``--finetune_decoder`` brings lossw down in ``chip_smoke.py``'s
baseline run (64 steps from the trained watermark model with the decoder's
last layer reset), on one NVIDIA GPU, over models trained as
``chip_smoke.py`` trains its own (its train phase's backbone, then 1000
watermark steps) and over the starts of that layer: zeroed, as the
baseline starts (``chip_smoke.py:zeroed_decoder_head``), and re-drawn at
its init from each of --seeds.  Each start runs both ways: looped
(``train_device``, dispatches of 16: the lossw of each, as the baseline
gates the last over the first) and per step (``WatermarkTrainer.train``:
each step's lossw, in means of 16).  One JSON line a run to --out, then a
summary by start against ``chip_smoke.py``'s FT_MARGIN.

    python3 scripts_port/ft_decoder_spread.py [--models 3] [--seeds 19] [--out FILE]
"""

import argparse
import gc
import json
import math
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def redrawn_decoder_head(state, seed):
    """A watermark checkpoint's state with the decoder's last layer (the
    linear map after the head) re-drawn from ``seed`` at its init (torch
    Linear's U(+-1/sqrt(fan_in)) for weight and bias); every other array
    shared with ``state``."""
    dec = state["trainable"]["decoder"]
    rng = np.random.default_rng(seed)
    bound = 1.0 / math.sqrt(dec["linear"]["w"].shape[0])
    linear = {k: rng.uniform(-bound, bound, v.shape).astype(v.dtype)
              for k, v in dec["linear"].items()}
    return {**state, "trainable": {**state["trainable"], "decoder": {**dec, "linear": linear}}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", type=int, default=3)
    ap.add_argument("--seeds", default="19")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ft_decoder_spread: no CUDA GPU visible; this script runs on the card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nerf_signature_tpu_torch.train.checkpoint import save_checkpoint, to_state_dict

    dev = torch.device("cuda")
    print(cs.phase_device(), flush=True)
    cs.phase_build()
    out = open(args.out, "w") if args.out else None
    rows = []
    steps = cs.BASE_STEPS
    for model in range(args.models):
        backbone = cs.phase_train(dev).pop("model")
        with tempfile.TemporaryDirectory() as d:
            w = cs.wm_train(dev, backbone, d)
            wm_state = to_state_dict(w["trainer"]._state(full=False))
            del w
            gc.collect()
            starts = [("zero", cs.zeroed_decoder_head(wm_state))] + [
                (f"seed {s}", redrawn_decoder_head(wm_state, int(s)))
                for s in args.seeds.split(",")]
            for start, state in starts:
                name = start.replace(" ", "_")
                ckpt = os.path.join(d, f"start_{name}", "ngp_ep0001.ckpt")
                save_checkpoint(ckpt, state)
                row = {"model": model, "start": start}
                for way, k in (("loop", cs.FT_K), ("per_step", 0)):
                    lossw = []
                    r = cs.wm_train(dev, backbone, os.path.join(d, f"{way}_{name}"), iters=steps,
                                    extra=["--finetune_decoder"], tag=f"ft {way} {name}",
                                    step_lossw=lossw, required=cs.FINETUNE_REQUIRED,
                                    k4_names=("K4_field",), ckpt=ckpt, steps_per_dispatch=k)
                    if k:
                        means = r["trainer"].stats["lossw"][-(steps // k):]
                    else:
                        means = [float(np.mean(lossw[i:i + cs.FT_K]))
                                 for i in range(0, steps, cs.FT_K)]
                    row[way] = {"lossw_by_16": [float(v) for v in means],
                                "last_over_first": float(means[-1] / means[0])}
                    del r
                    gc.collect()
                rows.append(row)
                print(json.dumps(row), flush=True)
                if out:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
        del backbone
        gc.collect()
    summary = {}
    for start in dict.fromkeys(r["start"] for r in rows):
        for way in ("loop", "per_step"):
            ratios = [r[way]["last_over_first"] for r in rows if r["start"] == start]
            firsts = [r[way]["lossw_by_16"][0] for r in rows if r["start"] == start]
            summary[f"{start}, {way}"] = {
                "runs": len(ratios), "first_16_min": min(firsts), "first_16_max": max(firsts),
                "last_over_first_min": min(ratios),
                "last_over_first_median": float(np.median(ratios)),
                "last_over_first_max": max(ratios),
                "runs_not_below_margin": sum(v >= cs.FT_MARGIN for v in ratios)}
    print(json.dumps({"margin": cs.FT_MARGIN, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
