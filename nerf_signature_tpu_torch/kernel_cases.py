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


def _distinct_and_lanes(r):
    """Per warp of r [..., 32] (a lane's row, -1 for a lane adding nothing):
    (the distinct rows among the adding lanes, the adding lanes)."""
    import torch

    s = torch.sort(r, dim=-1).values
    distinct = ((s[..., :1] >= 0).sum(-1)
                + ((s[..., 1:] != s[..., :-1]) & (s[..., 1:] >= 0)).sum(-1))
    return distinct, (r >= 0).sum(-1)


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
    distinct, lanes = _distinct_and_lanes(r.reshape(G, 32, L).transpose(1, 2))  # [G, L]
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
                   shared_table=False, dense_sides=None, combine=None, tile=None):
    """The atomic instructions K7's backward (``csrc/hashenc_stoch.cu``)
    issues on these inputs by its design, counted in plain PyTorch on the
    inputs' device.  Its tasks: per tile of ``tile`` samples (default the
    launcher's, ``ops/hashenc.py:stoch_bwd_tile``, which asks the built
    library), the live samples (a nonzero cotangent in the row's first L*F
    columns) in sample order, 32 a warp; per level slot
    j of L / s (s the effective ``level_stride``), lane = live sample at
    level j * s + its phase.  A lane adds where its cotangent at that level
    is nonzero; a warp whose adding lanes include a level in ``combine``
    issues one atomic for each distinct row among them, else one a lane;
    two at F = 8."""
    import torch

    from .ops import hashenc as t_hash

    M, L, F = x01.shape[0], len(resolutions), n_features
    dev = x01.device
    combine = t_hash.combine_mask(resolutions) if combine is None else combine
    tile = t_hash.stoch_bwd_tile(F, L) if tile is None else tile
    rows, phase_bits = t_hash.stochastic_choice(x01, resolutions, log2_hashmap_size,
                                                shared_table, dense_sides)
    stride = t_hash.effective_stride(L, level_stride)
    g = g_feat[:, :L * F].reshape(M, L, F)
    live = (g != 0).any(-1).any(-1)
    phase = (((phase_bits * t_hash._PHASE_MUL) & t_hash._U32) >> 13) % stride
    # each live sample's warp (tile, 32-sample chunk of the tile's live list) and lane
    sample = torch.arange(M, device=dev)
    n_tiles, warps = -(-M // tile), tile // 32
    count = torch.cumsum(live.to(torch.int64), 0)
    start = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    start[1:] = count[torch.clamp(torch.arange(1, n_tiles + 1, device=dev) * tile, max=M) - 1]
    rank = count - 1 - start[sample // tile]
    warp = (sample // tile * warps + rank // 32)[live]
    lane = (rank % 32)[live]
    combined = torch.tensor([(combine >> lv) & 1 for lv in range(L)], dtype=torch.bool,
                            device=dev)
    atomics = 0
    for j in range(L // stride):
        level = j * stride + phase
        adding = live & (g[sample, level] != 0).any(-1)
        r = torch.full((n_tiles * warps, 32), -1, dtype=torch.int64, device=dev)
        r[warp, lane] = torch.where(adding, rows[level, sample], -1)[live]
        c = torch.zeros((n_tiles * warps, 32), dtype=torch.bool, device=dev)
        c[warp, lane] = (adding & combined[level])[live]
        distinct, lanes = _distinct_and_lanes(r)
        atomics += int(torch.where(c.any(-1), distinct, lanes).sum())
    return atomics * (2 if F == 8 else 1)


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


def k6_density(x):
    """The edge cases' density query (any device): a ball of radius 1 whose
    sigma falls from 30 to exactly 0 at its edge, 0 outside (tmp = 0 then
    counts as queried and valid)."""
    import torch

    return torch.clamp_min(1.0 - (x * x).sum(-1), 0.0) * 30.0


def k6_edge_grids(C, H, full, seed=6):
    """numpy grid states and draws that drive K6 (the grid update) to the
    edges of its design: [(name, density [C, H^3] f32, live [C, H^3] f32,
    draws [(jitter [n, 3], rand_coords [q, 3] or None, occ_u [q] or None)]
    per cascade)].  ``empty``: nothing occupied (the partial update's
    uniform fallback); ``untrained``: every cell -1; ``one_cell``: a single
    occupied cell among -1s and 0s; ``edges``: a tenth occupied, the
    resample's u = 0, just below 1 and 1 exactly (u = count: the last
    occupied cell) and past 1 (the cdf's end, clamped), int32 coords, a
    cell drawn many times and cells that are also resampled (the last query
    of a cell wins); ``random``: a third untrained, a tenth occupied."""
    rng = np.random.default_rng(seed + 10 * C + H)
    H3 = H**3
    n, q = (H3, 0) if full else (2 * (H3 // 4), H3 // 4)
    cases = []
    for name in ("empty", "untrained", "one_cell", "edges", "random"):
        dens = np.zeros((C, H3), np.float32)
        if name == "untrained":
            dens[:] = -1.0
        elif name == "one_cell":
            dens[:, ::3] = -1.0
            dens[np.arange(C), rng.integers(0, H3, size=C) // 3 * 3 + 1] = 7.5
        elif name in ("edges", "random"):
            dens = rng.uniform(0.0, 40.0, size=(C, H3)).astype(np.float32)
            dens[rng.uniform(size=(C, H3)) > 0.1] = 0.0
            if name == "random":
                dens[rng.uniform(size=(C, H3)) < 0.33] = -1.0
        live = rng.uniform(-1.0, 30.0, size=(C, H3)).astype(np.float32)
        draws = []
        for cas in range(C):
            jitter = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
            if full:
                draws.append((jitter, None, None))
                continue
            coords = rng.integers(0, H, size=(q, 3))
            u = rng.uniform(size=q).astype(np.float32)
            if name == "edges":
                coords = coords.astype(np.int32)
                coords[: q // 8] = coords[0]  # one cell drawn q/8 times
                # cells that are also resampled
                occ = np.resize(np.flatnonzero(dens[cas] > 0), q // 4 - q // 8)
                coords[q // 8: q // 4] = np.stack([occ // (H * H), occ // H % H, occ % H], -1)
                u[:4] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 1.0, 1.5]
                u[4: q // 16] = 0.0
            draws.append((jitter, coords, u))
        cases.append((name, dens, live, draws))
    return cases
