"""Inputs that drive a kernel to the edges of its design, and counts of
what a kernel issues on given inputs (K1's and K7's backward atomics): one
maker for the card tests
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


def _warp_atomics(rows, adding, combine):
    """The atomics of one corner's adds over warp tasks (a level, 32
    consecutive samples): rows [M, L] int64, adding [M, L] bool; one atomic
    for each distinct row among the adding lanes at the levels in
    ``combine``, one for each adding lane elsewhere."""
    import torch

    M, L = rows.shape
    G = -(-M // 32)
    r = torch.full((G * 32, L), -1, dtype=torch.int64, device=rows.device)
    r[:M] = torch.where(adding, rows, -1)
    r = r.reshape(G, 32, L).transpose(1, 2)  # [G, L, 32]
    s = torch.sort(r, dim=-1).values
    distinct = ((s[..., :1] >= 0).sum(-1)
                + ((s[..., 1:] != s[..., :-1]) & (s[..., 1:] >= 0)).sum(-1))
    lanes = (r >= 0).sum(-1)
    grouped = torch.tensor([(combine >> lv) & 1 for lv in range(L)], dtype=torch.bool,
                           device=rows.device)
    return int(torch.where(grouped, distinct, lanes).sum())


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
    g = g_feat[:, :L * F].reshape(M, L, F)
    after = 0
    for idx, cw in t_hash._corners(x01, resolutions, log2_hashmap_size, shared_table,
                                   dense_sides, torch.float32):
        v = cw.t()[..., None] * g  # [M, L, F]
        if gather_dtype != torch.float32:
            v = v.to(gather_dtype).float()
        after += _warp_atomics(idx.t(), (v != 0).any(-1), combine)
    return after * (2 if F == 8 else 1)


def k7_bwd_atomics(x01, g_feat, n_features, resolutions, log2_hashmap_size, level_stride=1,
                   shared_table=False, dense_sides=None, combine=None):
    """The atomic instructions K7's backward (``csrc/hashenc_stoch.cu``)
    issues on these inputs by its design, counted as ``k1_bwd_atomics``
    counts K1's: one add per (level, sample) with a nonzero cotangent at a
    level it keeps (the effective ``level_stride``), into its chosen row,
    grouped by row at the levels in ``combine``; two at F = 8."""
    from .ops import hashenc as t_hash

    M, L, F = x01.shape[0], len(resolutions), n_features
    combine = t_hash.combine_mask(resolutions) if combine is None else combine
    rows, phase_bits = t_hash.stochastic_choice(x01, resolutions, log2_hashmap_size,
                                                shared_table, dense_sides)
    adding = (g_feat[:, :L * F].reshape(M, L, F) != 0).any(-1)
    stride = t_hash.effective_stride(L, level_stride)
    if stride > 1:
        adding &= t_hash.level_keep(phase_bits, L, stride).t()
    return _warp_atomics(rows.t(), adding, combine) * (2 if F == 8 else 1)


def k5_edge_inputs(seed=5):
    """K5's edge cases: a list of (name, mask [N, S] bool, xyzs [N, S, 3],
    rays_d [N, 3], Mc, sig_c [Mc], rgb_c [Mc, 3], g_sigmas [M], g_rgbs [M,
    3]) as numpy arrays: M not a multiple of 16 or of the pack's tile, every
    mask off, every mask on with Mc < M (rank >= Mc drops samples), Mc = M,
    a single live sample at the last index, N = 0, rays of 5 samples (a
    pack's tile spans more rays than it stages), and many tiles (137 of the
    pack's 2048 samples, more than its look-back's window of 32: rays whose
    samples are a prefix of their slots, as K2 writes them, beside rays of
    scattered samples; five tiles all off; Mc cutting inside the 133rd
    tile, so later tiles keep nothing)."""
    rng = np.random.default_rng(seed)
    cases = []

    def case(name, N, S, mask, Mc):
        xyzs = np.where(mask[..., None], rng.uniform(-1, 1, (N, S, 3)), 0.0).astype(np.float32)
        rays_d = rng.normal(size=(N, 3)).astype(np.float32)
        M = N * S
        cases.append((name, mask, xyzs, rays_d, Mc,
                      rng.normal(size=(Mc,)).astype(np.float32),
                      rng.uniform(size=(Mc, 3)).astype(np.float32),
                      rng.normal(size=(M,)).astype(np.float32),
                      rng.normal(size=(M, 3)).astype(np.float32)))

    case("ragged", 37, 29, rng.uniform(size=(37, 29)) < 0.3, 1024)
    case("all_off", 16, 128, np.zeros((16, 128), bool), 1024)
    case("all_on_drop", 24, 128, np.ones((24, 128), bool), 2048)
    mask = rng.uniform(size=(8, 256)) < 0.5
    case("mc_eq_m", 8, 256, mask, 8 * 256)
    last = np.zeros((5, 300), bool)
    last[-1, -1] = True
    case("last_only", 5, 300, last, 1024)
    case("empty", 0, 64, np.zeros((0, 64), bool), 0)
    case("short_rays", 700, 5, rng.uniform(size=(700, 5)) < 0.6, 2048)
    N, S = 2200, 127
    runs = np.arange(S)[None, :] < rng.integers(0, S + 1, size=(N, 1))
    mask = np.where(np.arange(N)[:, None] % 2 == 0, runs, rng.uniform(size=(N, S)) < 0.5)
    mask.reshape(-1)[3 * 2048:8 * 2048] = False
    case("many_tiles", N, S, mask, 128 * 1024)
    return cases
