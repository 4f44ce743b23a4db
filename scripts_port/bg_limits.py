#!/usr/bin/env python3
"""Read where K8's bf16 limits sit, on one NVIDIA GPU: the background
colour's kernels (``csrc/background.cu``) in bf16 against the plain chain,
and the control, the fp32 kernels on the bf16-rounded table and weights
(``mlp_apply``'s activation roundings skipped), at the random bg models of
``tests/test_torch_kernels.py:test_bg_color_kernels_match_chain`` (4 levels
x 2^15 rows, bg_net 4F + 16 -> 64 -> 3, F in {1, 2, 4, 8}, 4096 rays of seed
11 and 4133 of seed 50 + F): the relative L1 of the colour (the rays at
phi's cut left out) and of each gradient, for the kernels and the control,
beside the limits that test and ``chip_smoke.py`` hold them to
(``BG_RL1_BF16``).  One JSON line a case, then the extremes.

    python3 scripts_port/bg_limits.py [--out FILE]
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUTS = ("colour", "bg_table", "W1", "W2")


def rel_l1(a, b):
    return float((a.double() - b.double()).abs().sum() / b.double().abs().sum())


def case(dev, F, N, seed):
    """The card test's inputs (``_bg_inputs`` then ``_bg_color_case``)."""
    from nerf_signature_tpu_torch.ops import background as t_bg
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    g = torch.Generator().manual_seed(seed)
    o = (torch.randn((N, 3), generator=g) * 1.5).to(dev)
    d = torch.randn((N, 3), generator=g).to(dev)
    table = (torch.rand((4 << 15, F), generator=g) * 2 - 1).to(dev)
    IN = 4 * F + 16
    w1 = ((torch.rand((IN, 64), generator=g) * 2 - 1) * (6 / IN) ** 0.5).to(dev)
    w2 = ((torch.rand((64, 3), generator=g) * 2 - 1) * (6 / 64) ** 0.5).to(dev)
    meta = t_bg.BgMeta(tuple(t_hash.level_resolutions(4, 16, 2048).tolist()), 15, 8.0,
                       torch.bfloat16, 4)
    return o, d, table, [w1, w2], meta


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bg_limits: no CUDA GPU visible; this script runs on the card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nerf_signature_tpu_torch.ops import background as t_bg
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    dev = torch.device("cuda")
    rows = []
    for F in (1, 2, 4, 8):
        for N, seed in ((4096, 11), (4133, 50 + F)):
            o, d, table, net, meta = case(dev, F, N, seed)
            tg, packed = table.to(torch.bfloat16), t_bg.pack_bg_net(net, torch.bfloat16)
            meta_c = meta._replace(compute_dtype=torch.float32)
            ok = ~t_hash.sphere_cut(o, d, meta.radius)
            g = torch.randn((N, 3), generator=torch.Generator().manual_seed(F)).to(dev) * 1e-2
            g[~ok] = 0.0
            p = [t_bg.background_plain(o, d, table, net, meta, tg)[ok],
                 *t_bg.background_bwd_plain(o, d, table, net, g, meta, tg)]
            k = [t_bg.bg_color_kernel(o, d, tg, packed, meta)[ok],
                 *t_bg._bg_color_bwd_kernel(o, d, tg, packed, g, table.shape[0], meta)]
            c = [t_bg.bg_color_kernel(o, d, tg.float(), packed, meta_c)[ok],
                 *t_bg._bg_color_bwd_kernel(o, d, tg.float(), packed, g, table.shape[0],
                                            meta_c)]
            row = {"F": F, "rays": N, "seed": seed,
                   "kernel": {n: rel_l1(a, b) for n, a, b in zip(OUTS, k, p)},
                   "control": {n: rel_l1(a, b) for n, a, b in zip(OUTS, c, p)}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    res = {"gpu": cs.phase_device(), "limits": cs.BG_RL1_BF16,
           "kernel_max": {n: max(r["kernel"][n] for r in rows) for n in OUTS},
           "control_min": {n: min(r["control"][n] for r in rows) for n in OUTS}}
    res["between"] = all(res["kernel_max"][n] <= cs.BG_RL1_BF16[n] < res["control_min"][n]
                         for n in OUTS)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cases": rows, **res}, f, indent=1)
    return 0 if res["between"] else 1


if __name__ == "__main__":
    sys.exit(main())
