"""K7's backward (``csrc/hashenc_stoch.cu:hash_bwd_stoch``) emulated in
plain PyTorch and held against ``hash_encode_stoch_bwd_plain`` and JAX's
VJP of the stochastic path (``nerf_signature_tpu/ops/hashenc.py:
_make_interp_stochastic``) on the CPU.

The CUDA kernel cannot run here, so this file pins its schedule: a block
stages a tile of cotangent rows (the columns past L*F of a wider pitch
skipped), marking the rows that hold a nonzero value; it lists the tile's
live rows once, in sample order, each with its position and its level
phase, computed once a sample; its warps take tasks over the kept (level,
live sample) pairs only -- task (level slot j, 32 live samples), lane = live
sample at level j * s + its phase -- and skip a task whose 32 slices are all
zero; a lane draws its corner from the 8 weights and their running sum,
then computes that one corner's row (one index hashed); a task holding a
level in ``combine_mask`` groups the lanes adding into one row by
``__match_any_sync`` and sums them by ``reduce_peers``' shuffle tree (one
atomic a group), else each lane adds alone.  The emulation records every
lane's row and counts the atomics, which ``kernel_cases.k7_bwd_atomics``
(the count ``chip_smoke.py`` logs, as modelled) must equal.

Tolerances: the rows chosen equal the plain version's ``stochastic_choice``
at every kept (level, live sample), and no row of the gradient is touched
by one and not the other; relative L2 1e-6 against the plain version (the
same unrounded adds, only the fp32 sum order differs); against JAX's VJP
the parity bound of ``tests/test_torch_stochastic_hash.py`` (rtol 1e-5,
atol 1e-6).  Resolutions are powers of two there, so the scaled positions
are exact in both packages and no choice lies at the FMA margin (audited).
Inputs are numpy draws from seeds: ragged M, a tile with no live row, dead
rows, rows live at only some levels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.ops import hashenc as j_hash
from nerf_signature_tpu_torch.kernel_cases import k7_bwd_atomics
from nerf_signature_tpu_torch.ops import hashenc as t_hash
from test_torch_hashenc_bwd_warp import LANE, _match_any, _reduce_peers
from test_torch_train_ops import rel_l2

T = torch.from_numpy
U32 = 0xFFFFFFFF


def _res(L):
    """Powers of two from 16: every scaled position exact in fp32."""
    return 16.0 * 2.0 ** np.arange(L)


def _bits(t):
    return t.contiguous().view(torch.int32).to(torch.int64) & U32


def _phase(xc, res_last, stride):
    """A live sample's level phase, once a sample, from its clipped position
    and the last level's resolution (the kernel's level_phase)."""
    s = xc * torch.tensor(np.float32(res_last))
    b = [_bits(s[:, a]) for a in range(3)]
    pb = t_hash._hash24(b[0] ^ t_hash._PHASE_SALT, b[1], b[2])
    return ((((pb * t_hash._PHASE_MUL) & U32) >> 13) % stride).long()


def _chosen_row(sp, side, log2, off):
    """The kernel's chosen_row on [n, 3] scaled positions: the 8 weights in
    JAX's corner order and their running fp32 sum, the first corner c with
    u < sum, else 7; then that one corner's row (side 0: hashed)."""
    b = [_bits(sp[:, a]) for a in range(3)]
    u = t_hash._hash24(*b).to(torch.float32) * (1.0 / (1 << 24))
    f = torch.floor(sp)
    w, cell = sp - f, f.to(torch.int64)
    cum = torch.zeros_like(u)
    chosen = torch.full(u.shape, 7, dtype=torch.int64)
    done = torch.zeros(u.shape, dtype=torch.bool)
    for c in range(8):
        d = [(c >> 2) & 1, (c >> 1) & 1, c & 1]
        cw = [w[:, a] if d[a] else 1.0 - w[:, a] for a in range(3)]
        cum = cum + (cw[0] * cw[1]) * cw[2]
        newly = (u < cum) & ~done
        chosen = torch.where(newly, c, chosen)
        done = done | newly
    c3 = [cell[:, a] + ((chosen >> (2 - a)) & 1) for a in range(3)]
    hashed = t_hash._hash3(c3[0], c3[1], c3[2], log2)
    dense = (c3[0] * side + c3[1]) * side + c3[2]
    return (torch.where(side > 0, dense, hashed) + off) & U32


def emulate_stoch_bwd(x, g_feat, n_rows, res, log2, stride, shared=False, sides=None,
                      n_features=None, combine=None, tile=None):
    """The kernel's schedule: (the table's gradient [n_rows, F], the row each
    kept (level, live sample) chose [L, M] (-1 elsewhere), atomics issued,
    tasks run, tasks skipped)."""
    M, pitch = g_feat.shape
    L = len(res)
    F = n_features or pitch // L
    combine = t_hash.combine_mask(res) if combine is None else combine
    tile = t_hash.stoch_bwd_tile(F, L) if tile is None else tile
    res32 = torch.tensor(np.asarray(res, np.float32))
    offs = torch.tensor(t_hash.level_offsets(L, log2, shared, sides).astype(np.int64))
    side = torch.tensor(np.array(sides if sides is not None else [0] * L, np.int64))
    combined = torch.tensor([(combine >> lv) & 1 for lv in range(L)], dtype=torch.bool)
    grad = torch.zeros((n_rows, F))
    chosen = torch.full((L, M), -1, dtype=torch.int64)
    atomics = run = skipped = 0
    for m0 in range(0, M, tile):
        rows = min(tile, M - m0)
        sg = g_feat[m0:m0 + rows, :L * F].reshape(rows, L, F)
        # the live list, in sample order: rows, positions, phases
        live = torch.nonzero((sg != 0).any(-1).any(-1)).reshape(-1)
        n_live = live.numel()
        xc = torch.clamp(x[m0 + live], 0.0, 1.0)
        phase = _phase(xc, res[-1], stride) if stride > 1 else torch.zeros_like(live)
        chunks = -(-n_live // 32)
        k = torch.arange(chunks * 32).reshape(chunks, 32)
        active = k < n_live
        k = k.clamp(max=max(n_live - 1, 0))
        for j in range(L // stride):
            if not n_live:
                break
            level = j * stride + phase[k]  # [chunks, 32]
            g = sg[live[k], level]  # [chunks, 32, F]
            if stride > 1:
                g = g * float(stride)
            adding = active & (g != 0).any(-1)
            hot = adding.any(-1)
            run, skipped = run + int(hot.sum()), skipped + int((~hot).sum())
            sp = xc[k] * res32[level][..., None]
            row = _chosen_row(sp.reshape(-1, 3), side[level].reshape(-1), log2,
                              offs[level].reshape(-1)).reshape(chunks, 32)
            chosen[level[adding], m0 + live[k][adding]] = row[adding]
            grouped = (adding & combined[level]).any(-1, keepdim=True)
            peers = _match_any(row, adding)
            v = torch.where(grouped[..., None], _reduce_peers(peers, g), g)
            lead = adding & (~grouped | ((peers & ((1 << LANE) - 1)) == 0))
            grad.index_add_(0, row[lead], v[lead])
            atomics += int(lead.sum()) * (2 if F == 8 else 1)
    return grad, chosen, atomics, run, skipped


def _inputs(F, L, S=12, seed=0, sides=None, shared=False, pitch=None, all_zero=False):
    """x [M, 3] (some outside [0, 1]: clipped), cotangents [M, pitch]: M
    ragged over three tiles and a part, the second tile with no live row,
    every 3rd row dead, rows 5::7 live only at their first half of levels."""
    rng = np.random.default_rng(seed + 10 * F + L)
    tile = t_hash.stoch_bwd_tile(F, L)
    M = 3 * tile + 45
    rows = (int(j_hash.level_row_counts(sides, S).sum()) if sides
            else (1 << S) if shared else L << S)
    x = rng.uniform(-0.05, 1.05, size=(M, 3)).astype(np.float32)
    g = rng.normal(size=(M, L, F)).astype(np.float32)
    g[tile:2 * tile] = 0.0
    g[::3] = 0.0
    g[5::7, (L + 1) // 2:] = 0.0
    if all_zero:
        g[:] = 0.0
    g = g.reshape(M, L * F)
    if pitch is not None:
        wide = rng.normal(size=(M, pitch)).astype(np.float32)  # the padded columns: not read
        wide[:, :L * F] = g
        g = wide
    return x, g, rows


@functools.lru_cache(maxsize=None)
def _jax_grad(F, L, stride, addressing):
    """JAX's VJP of the stochastic path at one case's inputs (the table's
    gradient), computed once a case for the module's tests."""
    S, sides, shared = _addressing(L, addressing)
    x, g, rows = _inputs(F, L, S, sides=sides, shared=shared)
    table = np.random.default_rng(1).uniform(-1, 1, size=(rows, F)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_hash.hash_encode(
        jnp.asarray(x), t, _res(L), S, stochastic_grad=True, level_stride=stride,
        shared_table=shared, dense_sides=sides), jnp.asarray(table))
    (gj,) = vjp(jnp.asarray(g))
    return np.asarray(gj)


def _addressing(L, name):
    """(log2 size, dense sides, shared) of an addressing: hashed levels, the
    dense coarse level of a 2^14-row table, or one table for every level."""
    if name == "dense":
        return 14, j_hash.level_sides(_res(L), 14, True), False
    return 12, None, name == "shared"


CASES = ([(F, L, s, "hashed") for F in (1, 2, 4, 8) for L in (5, 16) for s in (1, 2, 4)]
         + [(2, 16, s, a) for a in ("dense", "shared") for s in (1, 2)])


@pytest.mark.parametrize("F,L,stride,addressing", CASES,
                         ids=[f"F{c[0]}-L{c[1]}-s{c[2]}-{c[3]}" for c in CASES])
def test_emulated_stoch_bwd_matches_plain_and_jax(F, L, stride, addressing):
    S, sides, shared = _addressing(L, addressing)
    res = _res(L)
    x, g, rows = _inputs(F, L, S, sides=sides, shared=shared)
    eff = t_hash.effective_stride(L, stride)
    ge, chosen, atomics, run, skipped = emulate_stoch_bwd(T(x), T(g), rows, res, S, eff, shared,
                                                          sides)
    gp = t_hash.hash_encode_stoch_bwd_plain(T(x), T(g), rows, res, S, eff, shared_table=shared,
                                            dense_sides=sides)
    assert float(gp.abs().max()) > 0 and run > 0
    assert rel_l2(ge.numpy(), gp.numpy()) <= 1e-6
    assert torch.equal(ge.ne(0).any(-1), gp.ne(0).any(-1))
    # every kept (level, live sample) chose the plain version's row
    want, phase_bits, margin = t_hash.stochastic_choice(T(x), res, S, shared, sides, audit=True)
    kept = chosen >= 0
    assert int(margin.sum()) == 0 and torch.equal(chosen[kept], want[kept])
    g3 = T(g)[:, :L * F].reshape(-1, L, F).permute(1, 0, 2)
    expect = (g3 != 0).any(-1)
    if eff > 1:
        expect &= t_hash.level_keep(phase_bits, L, eff)
    assert torch.equal(kept, expect)
    gj = _jax_grad(F, L, stride, addressing)
    np.testing.assert_allclose(ge.numpy(), gj, rtol=1e-5, atol=1e-6)
    assert np.array_equal(ge.ne(0).any(-1).numpy(), (gj != 0).any(-1))
    assert k7_bwd_atomics(T(x), T(g), F, res, S, stride, shared, sides) == atomics


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_emulated_stoch_bwd_cuts_the_work_by_the_stride(stride):
    """Tasks run only over kept (level, live sample) pairs: at stride s the
    lanes that add are the live samples' L / s kept levels, whatever their
    phase; the tile with no live row and the dead rows take no task."""
    F, L, S = 2, 16, 12
    res = _res(L)
    x, g, rows = _inputs(F, L, S, seed=4)
    _, chosen, atomics, run, skipped = emulate_stoch_bwd(T(x), T(g), rows, res, S, stride,
                                                         combine=0)
    g3 = T(g).reshape(-1, L, F)
    live = (g3 != 0).any(-1).any(-1)
    tile = t_hash.stoch_bwd_tile(F, L)
    n_live = [int(live[m0:m0 + tile].sum()) for m0 in range(0, live.numel(), tile)]
    assert n_live[1] == 0
    assert run + skipped == (L // stride) * sum(-(-n // 32) for n in n_live)
    # one add a kept (level, sample) whose slice is nonzero: L / s a sample
    # but for the rows live at only half their levels
    assert atomics == int((chosen >= 0).sum())
    full = live & ((g3 != 0).any(-1).sum(-1) == L)
    assert int((chosen[:, full] >= 0).sum()) == int(full.sum()) * (L // stride)


def test_emulated_stoch_bwd_reads_a_padded_pitch():
    """Cotangent rows at a wider pitch (K4's built input width): the
    columns past L*F are neither read nor make a row live."""
    F, L, S = 2, 12, 12
    res = _res(L)
    x, g, rows = _inputs(F, L, S, pitch=32)
    ge, _, _, _, _ = emulate_stoch_bwd(T(x), T(g), rows, res, S, 2, n_features=F)
    gp = t_hash.hash_encode_stoch_bwd_plain(T(x), T(np.ascontiguousarray(g[:, :L * F])), rows,
                                            res, S, 2)
    assert rel_l2(ge.numpy(), gp.numpy()) <= 1e-6


@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_emulated_stoch_bwd_of_zero_cotangents_runs_no_task(F):
    L, S = 5, 12
    x, g, rows = _inputs(F, L, S, all_zero=True)
    ge, chosen, atomics, run, skipped = emulate_stoch_bwd(T(x), T(g), rows, _res(L), S, 1)
    assert not bool(ge.any()) and atomics == run == skipped == 0 and not bool((chosen >= 0).any())


def test_tile_fits_the_shared_memory():
    """``ops/hashenc.py:stoch_bwd_tile``, the tile the wrapper hands the C
    entry (which refuses one that does not fit): 128 samples at every
    geometry the card takes but 32 x 8 (32), a multiple of 32 within the
    block's 256 threads, its shared memory (a staged row at
    ``stage_pitch``'s pitch, a position and a list entry a sample) within
    47 KB, and the largest such tile."""
    geometries = ((16, 2), (32, 2), (16, 4), (8, 8), (24, 1), (32, 8), (5, 1))
    assert [t_hash.stoch_bwd_tile(F, L) for L, F in geometries] == [128] * 5 + [32, 128]
    for L, F in geometries:
        LF = L * F
        words = ((LF | 1) if F == 1 else LF + 4 if F == 8 else LF + F) + 4
        tile = t_hash.stoch_bwd_tile(F, L)
        assert tile % 32 == 0 and 32 <= tile <= 256 and 4 * tile * words <= 47 * 1024
        assert tile == 128 or 4 * 2 * tile * words > 47 * 1024
