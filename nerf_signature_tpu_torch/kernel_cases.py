"""Inputs that drive a kernel to the edges of its design, and counts of
what a kernel issues on given inputs: one maker for the card tests
(``tests/test_torch_kernels.py``), the CPU emulations
(``tests/test_torch_composite_warp.py``, ``tests/test_torch_hashenc_bwd_warp.py``)
and ``chip_smoke.py``."""

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


def k1_bwd_atomics(x01, g_feat, n_features, resolutions, log2_hashmap_size, gather_dtype,
                   shared_table=False, dense_sides=None, combine=None):
    """The atomic instructions K1's backward (``csrc/hashenc.cu``) issues on
    these inputs by its design, counted in plain PyTorch on the inputs'
    device: per warp task (a level, 32 consecutive samples) and corner, one
    vector atomic for each distinct row among the lanes with a nonzero
    contribution at the levels in ``combine`` (default ``combine_mask``),
    one for each such lane elsewhere; two at F = 8.  ``g_feat``: [M, pitch],
    its first L*F columns read."""
    import torch

    from .ops import hashenc as t_hash

    M, L, F = x01.shape[0], len(resolutions), n_features
    combine = t_hash.combine_mask(resolutions) if combine is None else combine
    G = -(-M // 32)
    g = torch.zeros((G * 32, L, F), dtype=torch.float32, device=x01.device)
    g[:M] = g_feat[:, :L * F].reshape(M, L, F)
    after = 0
    for idx, cw in t_hash._corners(x01, resolutions, log2_hashmap_size, shared_table,
                                   dense_sides, torch.float32):
        v = cw.t()[..., None] * g[:M]  # [M, L, F]
        if gather_dtype != torch.float32:
            v = v.to(gather_dtype).float()
        adding = torch.zeros((G * 32, L), dtype=torch.bool, device=x01.device)
        adding[:M] = (v != 0).any(-1)
        rows = torch.full((G * 32, L), -1, dtype=torch.int64, device=x01.device)
        rows[:M] = idx.t()
        rows = torch.where(adding, rows, -1).reshape(G, 32, L).transpose(1, 2)  # [G, L, 32]
        s = torch.sort(rows, dim=-1).values
        distinct = ((s[..., :1] >= 0).sum(-1)
                    + ((s[..., 1:] != s[..., :-1]) & (s[..., 1:] >= 0)).sum(-1))
        lanes = (rows >= 0).sum(-1)
        grouped = torch.tensor([(combine >> lv) & 1 for lv in range(L)], dtype=torch.bool,
                               device=x01.device)
        after += int(torch.where(grouped, distinct, lanes).sum())
    return after * (2 if F == 8 else 1)
