#!/usr/bin/env python3
"""Train the port's full-width model on the analytic ball with and without
the auto group budget, on one NVIDIA GPU.

    python3 scripts_port/group_budget_probe.py

Each case is chip_smoke.py's ``train_case``: a fresh model trained through
``Trainer.train`` for 512 steps of 4096 rays (the CLI's train defaults, 32
views of 800x800).  It prints the held-out view's PSNR before and after, the
adaptations' moves and final state, and the last epochs' losses.  The cases:
the serving ball (radius 0.4) with the defaults (``--compact_frac -1
--group_budget -1``), the same with the static group budget
(``--group_budget 0``), and the train phase's ball (radius 0.7).
"""

import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

CASES = [("ball 0.4, defaults", 0.4, -1), ("ball 0.4, static group budget", 0.4, 0),
         ("ball 0.7, defaults", 0.7, -1)]


def main():
    if not torch.cuda.is_available():
        print("group_budget_probe: no CUDA GPU visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cs.phase_device()
    for name, radius, group in CASES:
        r = cs.train_case(dev, radius, cs.TRAIN_ITERS, group_budget=group)
        losses = r["trainer"].stats["loss"][-4:]
        print(f"[probe] {name}: held-out PSNR {r['psnr0']:.2f} -> {r['psnr1']:.2f} dB; "
              f"moves {r['moves']}; {cs.adaptation_state(r['trainer'].model)}; last 4 "
              f"epoch losses {[round(v, 6) for v in losses]}; {r['seconds']:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
