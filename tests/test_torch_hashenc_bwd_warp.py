"""K1's backward (``csrc/hashenc.cu:hash_encode_bwd``) emulated in plain
PyTorch and held against ``hash_encode_bwd_plain`` and JAX's VJP of
``hash_encode`` on the CPU.

The CUDA kernel cannot run here, so this file pins its algorithm: a block
stages a tile of samples (positions and cotangent rows, the columns past
L*F of a wider pitch skipped); a warp takes one (level, 32 consecutive
samples) task, lane = sample, and skips it when all 32 cotangents are zero
(a ballot); each lane's contribution at a corner is ``cw * g``, rounded to
bf16 on its own under a bf16 gather; at the levels ``combine_mask`` marks,
``__match_any_sync`` groups the lanes that add into one row and the
group's lowest lane sums its peers' contributions by ``reduce_peers``' tree
of shuffles (emulated shuffle by shuffle, so in its fp32 order) and issues
one vector atomic, a row add here; elsewhere each lane adds its own.  The
emulation also counts the atomics, which ``kernel_cases.k1_bwd_atomics``
(the count ``chip_smoke.py`` logs, as modelled, at the card's shapes) must equal.

Tolerances: relative L2 1e-6 against the plain version in fp32 and 1e-5
under a bf16 gather (both add the same rounded contributions; only the fp32
sum order differs), and 1e-6 against JAX's VJP, as for the table's
gradient in test_torch_geometry.  Inputs are numpy draws from seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.ops import hashenc as j_hash
from nerf_signature_tpu_torch.kernel_cases import k1_bwd_atomics
from nerf_signature_tpu_torch.ops import hashenc as t_hash
from test_torch_train_ops import rel_l2

LANES = 32
T = torch.from_numpy
LANE = torch.arange(LANES, dtype=torch.int64)
_MASK32 = 0xFFFFFFFF


def _stage_pitch(LF, F):
    return (LF | 1) if F == 1 else LF + 4 if F == 8 else LF + F


def _tile(LF, F):
    """The launcher's tile: the largest of 256, 128, 64, 32 samples whose
    staging fits 48 KB."""
    tile = 256
    while tile > 32 and 4 * tile * (3 + _stage_pitch(LF, F)) > 48 * 1024:
        tile //= 2
    return tile


def _popc(v):
    return sum((v >> b) & 1 for b in range(LANES))


def _ffs(v):
    """1 + the index of the lowest set bit, 0 for 0 (``__ffs``)."""
    low = v & -v
    out = torch.zeros_like(v)
    for b in range(LANES):
        out = torch.where(low == (1 << b), b + 1, out)
    return out


def _ballot(pred):
    """``__ballot_sync`` of each warp: [W, 32] bool -> [W, 1] int64 mask."""
    return (pred.to(torch.int64) << LANE).sum(-1, keepdim=True)


def _match_any(rows, adding):
    """``__match_any_sync(adding lanes, row)``: each adding lane's peers
    (itself included) as a bit mask, 0 for a lane that adds nothing."""
    eq = (rows[:, :, None] == rows[:, None, :]) & adding[:, None, :] & adding[:, :, None]
    return (eq.to(torch.int64) << LANE).sum(-1)


def _reduce_peers(peers, v):
    """``reduce_peers`` over warps [W, 32] of values v [W, 32, F], round by
    round: each lane still in its group's tree adds the value of the next
    peer above it (a shuffle), then the lanes at odd ranks leave."""
    rank = _popc(peers & ((1 << LANE) - 1))
    peers = peers & ((0xFFFFFFFE << LANE) & _MASK32)
    while bool((peers != 0).any()):
        nxt = _ffs(peers)
        src = ((nxt - 1) & 31)[..., None].expand_as(v)
        v = torch.where((nxt > 0)[..., None], v + torch.gather(v, 1, src), v)
        peers = peers & ~_ballot((rank & 1) == 1)
        rank = rank >> 1
    return v


def emulate_bwd(x, g_feat, n_rows, res, log2, gather_dtype, shared=False, sides=None,
                n_features=None, combine=None):
    """The kernel's algorithm: (the table's gradient [n_rows, F], atomics
    issued, warp tasks run, warp tasks skipped)."""
    M, pitch = g_feat.shape
    L = len(res)
    F = n_features or pitch // L
    combine = t_hash.combine_mask(res) if combine is None else combine
    tile = _tile(L * F, F)
    corners = list(t_hash._corners(x, res, log2, shared, sides, torch.float32))
    grad = torch.zeros((n_rows, F))
    atomics = run = skipped = 0
    for m0 in range(0, M, tile):
        rows = min(tile, M - m0)
        # the staged tile: the cotangents' first L*F columns of each row
        sg = g_feat[m0:m0 + rows, :L * F].reshape(rows, L, F)
        groups = -(-rows // LANES)
        for lv in range(L):
            # the level's tasks, one warp each (their order across the
            # block's warps only moves the fp32 sum order)
            g = torch.zeros((groups * LANES, F))
            g[:rows] = sg[:, lv]
            g = g.reshape(groups, LANES, F)
            hot = (g != 0).any(-1).any(-1)
            run, skipped = run + int(hot.sum()), skipped + int((~hot).sum())
            g = g[hot]
            sample = (torch.arange(groups * LANES).reshape(groups, LANES)[hot] + m0).clamp(
                max=M - 1)
            for idx, cw in corners:
                v = cw[lv][sample][..., None] * g
                if gather_dtype != torch.float32:
                    v = v.to(gather_dtype).float()
                adding = (v != 0).any(-1)
                row = idx[lv][sample]
                if (combine >> lv) & 1:
                    peers = _match_any(row, adding)
                    v = _reduce_peers(peers, v)
                    adding = adding & ((peers & ((1 << LANE) - 1)) == 0)  # the leaders
                grad.index_add_(0, row[adding], v[adding])
                atomics += int(adding.sum()) * (2 if F == 8 else 1)
    return grad, atomics, run, skipped


def _inputs(F, L, M, S=12, seed=0, zeros="half", sides=None, shared=False):
    rng = np.random.default_rng(seed + 10 * F + L)
    rows = (int(j_hash.level_row_counts(sides, S).sum()) if sides
            else (1 << S) if shared else L << S)
    x = rng.uniform(-0.05, 1.05, size=(M, 3)).astype(np.float32)
    g = rng.normal(size=(M, L * F)).astype(np.float32)
    if zeros == "half":
        g[: M // 2 - 40] = 0.0  # whole zero warps, and a ragged zero edge
        g[::7] = 0.0
    elif zeros == "all":
        g[:] = 0.0
    return x, g, rows


def _res(L):
    return j_hash.level_resolutions(L, 16, 2048)


# (F, L, M, gather, addressing): every F at 1, 5 and 16 levels on ragged
# tiles, hashed levels, bf16 (the -O path); then fp32, dense and the shared
# table (hash_select 0) at 5 levels
CASES = ([(F, L, 1000 + 37 * F, "bf16", "hashed") for F in (1, 2, 4, 8) for L in (1, 5, 16)]
         + [(F, 5, 777, g, a) for F in (1, 2, 8)
            for g, a in (("fp32", "hashed"), ("bf16", "dense"), ("bf16", "shared"))])


@pytest.mark.parametrize("F,L,M,gather,addressing", CASES,
                         ids=[f"F{c[0]}-L{c[1]}-{c[3]}-{c[4]}" for c in CASES])
def test_emulated_bwd_matches_plain_and_jax(F, L, M, gather, addressing):
    S = 12
    res = _res(L)
    sides = j_hash.level_sides(res, S, True) if addressing == "dense" else None
    shared = addressing == "shared"
    x, g, rows = _inputs(F, L, M, S, sides=sides, shared=shared)
    gd = torch.bfloat16 if gather == "bf16" else torch.float32
    ge, atomics, run, skipped = emulate_bwd(T(x), T(g), rows, res, S, gd, shared, sides)
    gp = t_hash.hash_encode_bwd_plain(T(x), T(g), rows, res, S, gd, shared_table=shared,
                                      dense_sides=sides)
    assert float(gp.abs().max()) > 0 and skipped > 0 and run > 0
    assert rel_l2(ge.numpy(), gp.numpy()) <= (1e-6 if gather == "fp32" else 1e-5)
    table = np.random.default_rng(1).uniform(-1, 1, size=(rows, F)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_hash.hash_encode(
        jnp.asarray(x), t, res, S, gather_dtype="bfloat16" if gather == "bf16" else None,
        shared_table=shared, dense_sides=sides), jnp.asarray(table))
    (gj,) = vjp(jnp.asarray(g))
    assert rel_l2(ge.numpy(), np.asarray(gj)) <= 1e-6
    assert k1_bwd_atomics(T(x), T(g), F, res, S, gd, shared, sides) == atomics


@pytest.mark.parametrize("F", [1, 8])
def test_emulated_bwd_reads_a_padded_pitch(F):
    """Cotangent rows at a wider pitch (K4's built input width): the
    columns past L*F are not read, whatever they hold."""
    L, S = 5, 12
    res = _res(L)
    x, g, rows = _inputs(F, L, 300, S)
    pitch = {1: 8, 8: 64}[F]
    wide = np.random.default_rng(3).normal(size=(300, pitch)).astype(np.float32)
    wide[:, :L * F] = g
    ge, _, _, _ = emulate_bwd(T(x), T(wide), rows, res, S, torch.bfloat16, n_features=F)
    gp = t_hash.hash_encode_bwd_plain(T(x), T(g), rows, res, S, torch.bfloat16)
    assert rel_l2(ge.numpy(), gp.numpy()) <= 1e-5


@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_emulated_bwd_of_zero_cotangents_adds_nothing(F):
    L, S = 5, 12
    res = _res(L)
    x, g, rows = _inputs(F, L, 500, S, zeros="all")
    ge, atomics, run, skipped = emulate_bwd(T(x), T(g), rows, res, S, torch.bfloat16)
    assert not bool(ge.any()) and atomics == 0 and run == 0 and skipped == 5 * 16


def test_reduce_peers_sums_each_group_pairwise_by_rank():
    """The tree's fp32 order: ((v0 + v1) + (v2 + v3)) + v4 for a group of 5
    lanes, whatever lanes the group holds, and every group at once."""
    rng = np.random.default_rng(4)
    key = torch.from_numpy(rng.integers(0, 4, size=(64, LANES)))
    adding = torch.from_numpy(rng.uniform(size=(64, LANES)) < 0.8)
    v = torch.from_numpy(rng.normal(size=(64, LANES, 1)).astype(np.float32)) * torch.from_numpy(
        10.0 ** rng.integers(-6, 6, size=(64, LANES, 1))).float()
    peers = _match_any(key, adding)
    out = _reduce_peers(peers, v)
    for w in range(64):
        for k in range(4):
            lanes = [i for i in range(LANES) if adding[w, i] and key[w, i] == k]
            if not lanes:
                continue
            vals = [v[w, i, 0] for i in lanes]
            while len(vals) > 1:
                vals = [vals[i] + vals[i + 1] if i + 1 < len(vals) else vals[i]
                        for i in range(0, len(vals), 2)]
            assert torch.equal(out[w, lanes[0], 0], vals[0])


def _ray_samples(n_rays, S, live, seed, step=np.sqrt(3) / 1024):
    """Positions in [0, 1]^3 along n_rays rays, S slots each at the march's
    step (bound 1, 1024 steps), the first ``live`` slots of a ray with a
    cotangent: the layout of the train and watermark steps' samples."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.3, 0.7, size=(n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (o + d * step * np.arange(S)[None, :, None]).reshape(-1, 3).astype(np.float32)
    hot = (np.arange(S) < live)[None, :].repeat(n_rays, 0).reshape(-1)
    return x, hot


def _atomics_one_thread_a_sample_level(x, g, res, S):
    """What the design this kernel replaced issued at F = 2 under a bf16
    gather: one thread a (sample, level), one scalar atomic for each nonzero
    rounded feature contribution of each corner."""
    M, L = x.shape[0], len(res)
    g3 = g.reshape(M, L, 2)
    n = 0
    for _, cw in t_hash._corners(x, res, S, False, None, torch.float32):
        n += int(((cw.t()[..., None] * g3).to(torch.bfloat16) != 0).sum())
    return n


@pytest.mark.parametrize("shape", ["clean", "wm"])
def test_atomics_before_and_after_on_ray_samples(shape):
    """A clean-step-like input (16 levels x 2 features, 128 slots a ray, the
    first 24 live) and a watermark-step-like one (the message's one level at
    resolution 2048, 256 slots a ray, the first 96 live): the emulation's
    count equals ``k1_bwd_atomics``', and the grouping and float2 atomics
    issue at most half what one scalar atomic a nonzero feature did; at
    the clean shape's coarse levels far fewer than without the grouping."""
    S = 12
    L, res, slots, live = ((16, _res(16), 128, 24) if shape == "clean"
                           else (1, np.array([2048.0]), 256, 96))
    x, hot = _ray_samples(16, slots, live, seed=5)
    g = np.random.default_rng(6).normal(size=(x.shape[0], 2 * L)).astype(np.float32)
    g[~hot] = 0.0
    rows = L << S
    ge, atomics, _, skipped = emulate_bwd(T(x), T(g), rows, res, S, torch.bfloat16)
    assert k1_bwd_atomics(T(x), T(g), 2, res, S, torch.bfloat16) == atomics and skipped > 0
    assert 2 * atomics <= _atomics_one_thread_a_sample_level(T(x), T(g), res, S)
    gp = t_hash.hash_encode_bwd_plain(T(x), T(g), rows, res, S, torch.bfloat16)
    assert rel_l2(ge.numpy(), gp.numpy()) <= 1e-5
    if shape == "clean":
        # all 16 levels: the grouping (9 levels at resolution <= 256) cuts
        # the count by a third or more; the coarsest level (resolution 16,
        # a ray's 24 live slots within one cell or two) by 8x or more
        ungrouped = k1_bwd_atomics(T(x), T(g), 2, res, S, torch.bfloat16, combine=0)
        assert 3 * atomics <= 2 * ungrouped
        coarse = [k1_bwd_atomics(T(x), T(g[:, :2]), 2, res[:1], S, torch.bfloat16, combine=c)
                  for c in (1, 0)]
        assert 8 * coarse[0] <= coarse[1]
