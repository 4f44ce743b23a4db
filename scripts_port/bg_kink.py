#!/usr/bin/env python3
"""Read how the background colour's backward (``csrc/background.cu``)
differs from the plain chain's (``ops/background.py:background_bwd_plain``)
on bg models trained as ``chip_smoke.py`` trains its own (512 looped steps
with ``--bg_radius 8`` on the sky views), on one NVIDIA GPU: over many
batches of 4096 training rays, in fp32 and bf16, the relative L2 and L1 of
the table's, W1's and W2's gradients with the rays at bg_net's ReLU kink
(``background.relu_margin`` under a margin) given no cotangent, at margins
0, 1e-6, 1e-5, 1e-4 and 1e-3, and how many rays each leaves out.  In fp32,
where a batch reads above 1e-4 over all rays, it finds the rays that
disagree alone (one ray's cotangent at a time, the 64 nearest the kink) and
prints their margins.  One JSON line a batch to --out, a summary a model.

    python3 scripts_port/bg_kink.py [--models 3] [--batches 40] [--out FILE]
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARGINS = (0.0, 1e-6, 1e-5, 1e-4, 1e-3)


def disagree_alone(cs, t_bg, ro, rd, tg, packed, table, net, g0, marg, meta):
    """The rays whose own cotangent moves W1's gradient by more than 1e-3
    relative L2 between the kernel and the chain, among the 64 nearest the
    kink."""
    bad = []
    for i in torch.argsort(marg)[:64].tolist():
        if not bool(g0[i].abs().sum() > 0):
            continue
        g = torch.zeros_like(g0)
        g[i] = g0[i]
        gk = t_bg._bg_color_bwd_kernel(ro, rd, tg, packed, g, table.shape[0], meta)
        gp = t_bg.background_bwd_plain(ro, rd, table, net, g, meta, tg)
        e = cs.rel_l2(gk[1], gp[1])
        if e > 1e-3:
            bad.append({"ray": i, "margin": float(marg[i]), "w1_rel_l2": e})
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", type=int, default=3)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bg_kink: no CUDA GPU visible; this script runs on the card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import background as t_bg
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    dev = torch.device("cuda")
    gpu = cs.phase_device()
    _cuda.library()
    out = open(args.out, "w") if args.out else None
    summary = {"gpu": gpu}
    flips = []
    for model_i in range(args.models):
        r = cs.train_case(dev, cs.TRAIN_BALL, cs.TRAIN_ITERS, steps_per_dispatch=cs.DL_K,
                          bg_radius=cs.BG_RADIUS, views=cs.SkyBallViews)
        m = r["trainer"].model
        table = m.params["bg_table"].detach()
        net = [w.detach() for w in m.params["bg_net"]]
        for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            cfg = dataclasses.replace(m.cfg, compute_dtype=dtype)
            meta = t_ngp.bg_meta(cfg)
            bp = t_ngp.bg_params({"bg_table": table, "bg_net": net}, cfg)
            tg, packed = bp["bg_table_g"], bp["bg_packed"]
            for seed in range(args.batches):
                ro, rd = cs.train_rays(dev, seed=seed + 3)
                N = ro.shape[0]
                cut = t_hash.sphere_cut(ro, rd, meta.radius)
                marg = t_bg.relu_margin(ro, rd, table, net, meta, tg)
                gen = torch.Generator(device=dev).manual_seed(1000 + seed)
                g0 = torch.randn((N, 3), generator=gen, device=dev) * 1e-2
                g0[cut] = 0.0
                row = {"model": model_i, "dtype": dname, "seed": seed, "cut": int(cut.sum()),
                       "margin_min": float(marg.min())}
                for eps in MARGINS:
                    g = g0.clone()
                    left = marg < eps
                    g[left] = 0.0
                    gk = t_bg._bg_color_bwd_kernel(ro, rd, tg, packed, g, table.shape[0], meta)
                    gp = t_bg.background_bwd_plain(ro, rd, table, net, g, meta, tg)
                    row[f"{eps:g}"] = {"left": int(left.sum()),
                                       "rel_l2": [cs.rel_l2(a, b) for a, b in zip(gk, gp)],
                                       "rel_l1": [cs.rel_l1(a, b) for a, b in zip(gk, gp)]}
                    s = summary.setdefault(f"{dname} margin {eps:g}", {
                        "worst_rel_l2": [0.0] * 3, "worst_rel_l1": [0.0] * 3, "max_left": 0,
                        "batches_above_1e-3": 0})
                    s["worst_rel_l2"] = [max(a, b) for a, b in
                                         zip(s["worst_rel_l2"], row[f"{eps:g}"]["rel_l2"])]
                    s["worst_rel_l1"] = [max(a, b) for a, b in
                                         zip(s["worst_rel_l1"], row[f"{eps:g}"]["rel_l1"])]
                    s["max_left"] = max(s["max_left"], int(left.sum()))
                    s["batches_above_1e-3"] += max(row[f"{eps:g}"]["rel_l2"]) > 1e-3
                if dname == "fp32" and max(row["0"]["rel_l2"][:2]) > 1e-4:
                    row["disagree_alone"] = disagree_alone(cs, t_bg, ro, rd, tg, packed, table,
                                                           net, g0, marg, meta)
                    flips += [b["margin"] for b in row["disagree_alone"]]
                if out:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
        del r, m
        summary["fp32 flips"] = len(flips)
        summary["fp32 flip margin max"] = max(flips, default=None)
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
