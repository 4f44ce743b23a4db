"""Inputs that drive a kernel to the edges of its design, one maker for the
card tests (``tests/test_torch_kernels.py``), the CPU emulations
(``tests/test_torch_composite_warp.py``) and ``chip_smoke.py``."""

import numpy as np


def k3_edge_inputs(N, S, mask_kind, seed=8):
    """numpy compositor inputs (sigmas, rgbs, deltas, ts, mask) with rays
    that stop inside the first 32-slot chunk, at slot 31 and at slot 32 (an
    opaque slot of tau = 20 just before: a larger tau would lose T_in's
    precision in cum - tau, in every version), opaque rays, and the mask
    random ("on"), absent ("off", None) or all off ("all_masked")."""
    rng = np.random.default_rng(seed + S)
    sig = rng.exponential(3.0, size=(N, S)).astype(np.float32)
    sig[N // 2:] *= 60.0
    rgb = rng.uniform(size=(N, S, 3)).astype(np.float32)
    dt = rng.uniform(0.005, 0.05, size=(N, S)).astype(np.float32)
    mask = rng.uniform(size=(N, S)) < 0.8
    for row, slot in ((0, 0), (1, 30), (2, 31), (3, 5)):
        if slot < S:
            sig[row, :slot] = 0.01
            sig[row, slot], dt[row, slot] = 400.0, 0.05
            mask[row, :slot + 1] = True
    ts = np.cumsum(dt, axis=-1).astype(np.float32)
    if mask_kind == "all_masked":
        mask[:] = False
    return sig, rgb, dt, ts, (None if mask_kind == "off" else mask)
