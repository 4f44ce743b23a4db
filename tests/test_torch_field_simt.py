"""K4's tiled SIMT kernels (fp32: ``csrc/field.cu:field_fwd``,
``csrc/field_feat.cu:field_bwd_feat`` and ``csrc/field_bwd.cu:field_bwd``)
on the CPU: their launch plan and their design.

``models/ngp.py:simt_launch`` computes the dynamic shared memory and the
persistent grid that the wrappers pass; the launchers refuse any other size
(``csrc/field_common.cuh:SimtDims``, ``csrc/field_bwd.cu:BwdDims``).
Here: every built width fits a block
(232,448 B on the H100), the forward fits two blocks an SM, and the tiles
are the sources' own.  ``MicroTile``'s thread map is mirrored in Python and
covers each (sample, output) of a layer's product once, with a warp's
16-byte activation loads contiguous.  The kernels' buffer plan (the
activation rows each layer reads and writes, o[j] at row 15 + j under the
SH rows, the transposed weights as the backward stages them, the ReLU mask
as bits, gh[0] from trunc_exp's clamped VJP, the backward's tiles of
queued live samples with a zero g_feat elsewhere) is emulated tile by tile
in fp32 and held against JAX's ``_sigma_head`` / ``ngp_color``
and their VJP in feat (1e-5: the same products summed in another order).
The full backward's plan (three buffers, each weight gradient A^T G
while both are held, the sigma MLP recomputed) runs over a grid of
several blocks taking chunks by the fixed assignment, each queueing its
live samples in order, dW summed tile by tile and then block by block in
block order, and is held against JAX's VJP in feat and in the five weight
leaves (1e-5 relative L2).  ``WgradTile``'s thread map is mirrored too:
each weight once, a quarter-warp's 16-byte loads in distinct banks.
The kernels themselves run on the card (``test_torch_kernels.py``).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import _cuda
from nerf_signature_tpu_torch.ops.sh import sh_encode

SMEM_BLOCK = 232_448  # the most dynamic shared memory a block may opt in to (H100)
SMEM_SM = 233_472  # an SM's shared memory (228 KB), 1 KB of it reserved a block
KINDS = ("fwd", "bwd_feat", "bwd")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("widths", _cuda.FIELD_WIDTHS)
def test_shared_memory_fits_at_every_width(widths, kind):
    tile, smem, _ = t_ngp.simt_launch(widths, kind)
    assert smem < SMEM_BLOCK
    per_sm = t_ngp.SIMT_BLOCKS_PER_SM[kind]
    assert per_sm * (smem + 1024) <= SMEM_SM
    # the activation buffers, the weights and (backward) what only it stages
    in_dim, hidden, out1, hc = widths
    assert smem >= 4 * (2 * max(in_dim, hidden, hc, 15 + out1) * tile + t_ngp._n_weights(widths))


def _define(src, name):
    with open(os.path.join(_cuda.CSRC, src)) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


def test_tiles_are_the_sources_own():
    """SIMT_TILE is NGP_FWD_T / NGP_BWD_FEAT_T / NGP_BWD_T (samples a tile
    = threads a block) of the three sources."""
    for kind, (src, name) in {"fwd": ("field.cu", "NGP_FWD_T"),
                              "bwd_feat": ("field_feat.cu", "NGP_BWD_FEAT_T"),
                              "bwd": ("field_bwd.cu", "NGP_BWD_T")}.items():
        assert _define(src, name) == t_ngp.SIMT_TILE[kind]


def test_bwd_row_stride_and_round_are_the_sources_own():
    """The full backward's row stride (a tile's samples and 4 more floats,
    so that consecutive rows start 4 banks apart) and its chunks a scan
    round, as field_bwd.cu defines them."""
    assert _define("field_bwd.cu", "NGP_BWD_LD") == t_ngp.BWD_LD
    assert _define("field_bwd.cu", "NGP_BWD_U") == t_ngp.BWD_ROUND
    assert t_ngp.BWD_LD == t_ngp.SIMT_TILE["bwd"] + 4 and t_ngp.BWD_LD % 32 == 4


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M", [1, 127, 128, 129, 257, 4097, 1 << 20])
def test_persistent_grid(kind, M):
    """One block a tile up to the SMs' share, never none."""
    tile, _, blocks = t_ngp.simt_launch(_cuda.FIELD_WIDTHS[0], kind, M, 132)
    assert blocks == min(-(-M // tile), t_ngp.SIMT_BLOCKS_PER_SM[kind] * 132)
    assert t_ngp.simt_launch(_cuda.FIELD_WIDTHS[0], kind, 0, 132)[2] == 1


def micro_tile(T, N):
    """field_common.cuh:MicroTile's map: per thread, its samples and outputs
    and the first sample of each 16-byte activation load."""
    rn = 8 if N == 64 else (2 if N == 8 else 4)
    rm = N // rn
    nx = T // rm
    for tid in range(T):
        lane, warp = tid & 31, tid >> 5
        tx = (warp % (nx // 8)) * 8 + (lane & 7)
        ty = (warp // (nx // 8)) * 4 + (lane >> 3)
        loads = [h * (T // 2) + 4 * tx for h in range(rm // 4)]
        samples = [s + i for s in loads for i in range(4)]
        outs = [(jj >> 2) * (N // 2) + 4 * ty + (jj & 3) if rn == 8 else rn * ty + jj
                for jj in range(rn)]
        yield tid, loads, samples, outs


# the products the kernels run: (tile, output width)
PRODUCTS = sorted({(t_ngp.SIMT_TILE["fwd"], n) for w in _cuda.FIELD_WIDTHS
                   for n in (w[1], w[2], w[3])} |
                  {(t_ngp.SIMT_TILE[k], n) for k in ("bwd_feat", "bwd")
                   for w in _cuda.FIELD_WIDTHS for n in (w[0], w[1], w[2], w[3])})


@pytest.mark.parametrize("T,N", PRODUCTS)
def test_micro_tile_owns_each_output_once(T, N):
    seen = np.zeros((T, N), np.int64)
    by_warp = {}
    for tid, loads, samples, outs in micro_tile(T, N):
        assert all(s % 4 == 0 for s in loads)  # 16-byte aligned float4 loads
        for s in samples:
            for n in outs:
                seen[s, n] += 1
        by_warp.setdefault(tid >> 5, []).append((tid & 31, loads, outs))
    assert (seen == 1).all()
    for lanes in by_warp.values():
        # each 8 lanes' first activation load spans 128 contiguous bytes; a
        # warp reads at most 4 distinct weight vectors a row
        for q in range(4):
            firsts = sorted(lo[0] for lane, lo, _ in lanes if lane // 8 == q)
            assert firsts == list(range(firsts[0], firsts[0] + 32, 4))
        assert len({tuple(o) for _, _, o in lanes}) <= 4


def _weights(widths, seed):
    rng = np.random.default_rng(seed)
    in_dim, hidden, out1, hc = widths
    shapes = [(in_dim, hidden), (hidden, out1), (15 + out1, hc), (hc, hc), (hc, 3)]
    return [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for s in shapes]


def _inputs(widths, M, seed):
    rng = np.random.default_rng(seed)
    feat = rng.uniform(-1, 1, (M, widths[0])).astype(np.float32)
    d = rng.standard_normal((M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return feat, d


def _split(flat, widths):
    in_dim, hidden, out1, hc = widths
    shapes = [(in_dim, hidden), (hidden, out1), (15 + out1, hc), (hc, hc), (hc, 3)]
    return [v.reshape(s) for v, s in zip(torch.split(flat, [a * b for a, b in shapes]), shapes)]


def emulate(flat, widths, feat, dirs, g_sigma=None, g_rgb=None, kind="fwd", blocks=1):
    """The kernels' plan in fp32, tile by tile: (sigma, geo, rgb) for "fwd"
    (tiles of consecutive samples), g_feat for "bwd_feat" (tiles of the
    queued live samples; the others written 0), (g_feat, g_flat) for "bwd"
    (``_emulate_bwd``, over ``blocks`` blocks)."""
    in_dim, hidden, out1, hc = widths
    T = t_ngp.SIMT_TILE[kind]
    rows = max(in_dim, hidden, hc, 15 + out1)
    Ws0, Ws1, Wc0, Wc1, Wc2 = _split(flat, widths)
    W1 = flat[in_dim * hidden:]  # Ws1 onwards, flat
    Wc0f = flat[in_dim * hidden + hidden * out1:]
    # the backward's staging loops, index for index
    WT1 = torch.tensor([Wc1.reshape(-1)[(i % hc) * hc + i // hc] for i in range(hc * hc)])
    WT0 = torch.tensor([0.0 if i % out1 == 0 else Wc0f[(15 + i % out1) * hc + i // out1]
                        for i in range(hc * out1)])
    WTs1 = torch.tensor([W1[(i % hidden) * out1 + i // hidden] for i in range(out1 * hidden)])
    WTs0 = torch.tensor([flat[(i % in_dim) * hidden + i // in_dim]
                         for i in range(hidden * in_dim)])
    WT1, WT0 = WT1.reshape(hc, hc), WT0.reshape(hc, out1)
    WTs1, WTs0 = WTs1.reshape(out1, hidden), WTs0.reshape(hidden, in_dim)
    M = feat.shape[0]
    if kind == "bwd":
        return _emulate_bwd(flat, widths, feat, dirs, g_sigma, g_rgb, blocks, (WT1, WT0, WTs1, WTs0))
    if kind == "fwd":
        tiles = [torch.arange(b, min(b + T, M)) for b in range(0, M, T)]
    else:
        live = torch.nonzero((g_sigma != 0) | (g_rgb != 0).any(-1))[:, 0]
        tiles = list(torch.split(live, T))
        g_feat = torch.zeros((M, in_dim))
    outs = []
    for idx in tiles:
        n = idx.shape[0]
        pad = lambda a: torch.cat([a[idx], a.new_zeros((T - n,) + a.shape[1:])])
        P, Q = torch.zeros((rows, T)), torch.zeros((rows, T))
        P[:in_dim] = pad(feat).T
        Q[:hidden] = torch.relu(Ws0.T @ P[:in_dim])
        P[15:15 + out1] = Ws1.T @ Q[:hidden]
        h0 = P[15].clone()
        geo = P[16:15 + out1].T.clone()
        mask_h = Q[:hidden] > 0  # the bits a sample
        P[:16] = sh_encode(pad(dirs), 4).T
        Q[:hc] = torch.relu(Wc0.T @ P[:15 + out1])
        P[:hc] = torch.relu(Wc1.T @ Q[:hc])
        c3 = Wc2.T @ P[:hc]
        if kind == "fwd":
            outs.append((torch.exp(h0)[:n], geo[:n], torch.sigmoid(c3).T[:n]))
            continue
        s = torch.sigmoid(c3)
        gc3 = pad(g_rgb).T * (s * (1.0 - s))
        P[:hc] = torch.where(P[:hc] > 0, Wc2 @ gc3, 0.0)  # in place over c2
        Q[:hc] = torch.where(Q[:hc] > 0, WT1.T @ P[:hc], 0.0)  # in place over c1
        P[:out1] = WT0.T @ Q[:hc]
        P[0] = pad(g_sigma) * torch.exp(torch.clamp(h0, -15.0, 15.0))
        Q[:hidden] = torch.where(mask_h, WTs1.T @ P[:out1], 0.0)
        g_feat[idx] = (WTs0.T @ Q[:hidden]).T[:n]
    if kind == "fwd":
        return tuple(torch.cat(o) for o in zip(*outs))
    return g_feat


def _emulate_bwd(flat, widths, feat, dirs, g_sigma, g_rgb, blocks, transposes):
    """field_bwd's plan: block b scans chunks of 32 samples (a warp's) b,
    b + G, ... (G = blocks), BWD_ROUND a warp a round, queues the live
    samples in its chunk order and writes g_feat 0 for the others; each full
    queue (and the last) is a tile.  Per
    tile, the buffers P, Q, R (NaN until written) and G3 as the kernel uses
    them, each weight gradient A^T G while both are held, added to the
    block's partials row (stored at its first tile); a block with no tile
    writes zeros; g_flat is the rows' sum in block order."""
    in_dim, hidden, out1, hc = widths
    T, U = t_ngp.SIMT_TILE["bwd"], t_ngp.BWD_ROUND
    rows = max(in_dim, hidden, hc, 32)
    cin = 15 + out1
    Ws0, Ws1, Wc0, Wc1, Wc2 = _split(flat, widths)
    WT1, WT0, WTs1, WTs0 = transposes
    sizes = [in_dim * hidden, hidden * out1, cin * hc, hc * hc, hc * 3]
    M = feat.shape[0]
    n_chunks = -(-M // 32)
    per_round = U * T // 32  # BWD_ROUND chunks for each of the block's warps
    live = ((g_sigma != 0) | (g_rgb != 0).any(-1)).tolist()
    g_feat = torch.full((M, in_dim), float("nan"))
    partials = torch.full((blocks, flat.numel()), float("nan"))
    for b in range(blocks):
        queue, chunk, first = [], b, True
        P, Q, R, G3 = (torch.full((r, T), float("nan")) for r in (rows, rows, rows, 4))
        while True:
            while chunk < n_chunks and len(queue) < T:
                for k in range(per_round):
                    c = chunk + k * blocks
                    for m in range(c * 32, min(c * 32 + 32, M)):
                        if live[m]:
                            queue.append(m)
                        else:
                            g_feat[m] = 0.0
                chunk += per_round * blocks
            if not queue:
                break
            idx, queue = torch.tensor(queue[:T]), queue[T:]
            n = idx.shape[0]
            pad = lambda a: torch.cat([a[idx], a.new_zeros((T - n,) + a.shape[1:])])
            P[:in_dim] = pad(feat).T
            Q[:hidden] = torch.relu(Ws0.T @ P[:in_dim])
            P[15:15 + out1] = Ws1.T @ Q[:hidden]
            h0 = P[15].clone()
            P[:16] = torch.cat([sh_encode(dirs[idx], 4), torch.zeros((T - n, 16))]).T
            Q[:hc] = torch.relu(Wc0.T @ P[:cin])
            R[:hc] = torch.relu(Wc1.T @ Q[:hc])
            s = torch.sigmoid(Wc2.T @ R[:hc])
            G3[:3] = pad(g_rgb).T * (s * (1.0 - s))
            dWc2 = R[:hc] @ G3[:3].T
            R[:hc] = torch.where(R[:hc] > 0, Wc2 @ G3[:3], 0.0)  # g2 over c2
            dWc1 = Q[:hc] @ R[:hc].T
            Q[:hc] = torch.where(Q[:hc] > 0, WT1.T @ R[:hc], 0.0)  # g1 over c1
            dWc0 = P[:cin] @ Q[:hc].T
            R[:out1] = WT0.T @ Q[:hc]
            R[0] = pad(g_sigma) * torch.exp(torch.clamp(h0, -15.0, 15.0))
            P[:in_dim] = pad(feat).T
            Q[:hidden] = torch.relu(Ws0.T @ P[:in_dim])
            dWs1 = Q[:hidden] @ R[:out1].T
            Q[:hidden] = torch.where(Q[:hidden] > 0, WTs1.T @ R[:out1], 0.0)  # gh1 over h
            dWs0 = P[:in_dim] @ Q[:hidden].T
            g_feat[idx] = (WTs0.T @ Q[:hidden]).T[:n]
            tile = torch.cat([w.reshape(-1) for w in (dWs0, dWs1, dWc0, dWc1, dWc2)])
            partials[b] = tile if first else partials[b] + tile
            first = False
        if first:
            partials[b] = 0.0
    g_flat = torch.zeros(sum(sizes))
    for b in range(blocks):
        g_flat = g_flat + partials[b]
    return g_feat, g_flat


def _jax_heads(ws, feat, d):
    jcfg = j_ngp.NGPConfig(compute_dtype=jnp.float32)
    pj = {"sigma_net": [jnp.asarray(w) for w in ws[:2]],
          "color_net": [jnp.asarray(w) for w in ws[2:]]}

    def heads(f):
        sigma, geo = j_ngp._sigma_head(pj, jcfg, f)
        return sigma, geo, j_ngp.ngp_color(pj, jcfg, jnp.asarray(d), geo)

    return heads


@pytest.mark.parametrize("widths", _cuda.FIELD_WIDTHS)
def test_forward_plan_matches_jax(widths):
    """A ragged last tile (2 tiles and 1 sample)."""
    ws = _weights(widths, 0)
    M = 2 * t_ngp.SIMT_TILE["fwd"] + 1
    feat, d = _inputs(widths, M, 1)
    flat = torch.cat([torch.from_numpy(w).reshape(-1) for w in ws])
    got = emulate(flat, widths, torch.from_numpy(feat), torch.from_numpy(d))
    want = _jax_heads(ws, feat, d)(jnp.asarray(feat))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("widths", _cuda.FIELD_WIDTHS)
def test_bwd_feat_plan_matches_jax_vjp(widths):
    """Chunk 0 mixes live samples with all-zero cotangents, chunk 1 is all
    zero (g_feat exactly 0 there), the last chunk and the last tile are
    ragged."""
    ws = _weights(widths, 2)
    T = t_ngp.SIMT_TILE["bwd_feat"]
    M = 2 * T + 3
    feat, d = _inputs(widths, M, 3)
    rng = np.random.default_rng(4)
    g_sigma = rng.standard_normal(M).astype(np.float32) * 1e-3
    g_rgb = rng.standard_normal((M, 3)).astype(np.float32) * 1e-3
    dead = (np.arange(M) % 3 == 0) | ((np.arange(M) >= T) & (np.arange(M) < 2 * T))
    g_sigma[dead], g_rgb[dead] = 0.0, 0.0
    flat = torch.cat([torch.from_numpy(w).reshape(-1) for w in ws])
    got = emulate(flat, widths, torch.from_numpy(feat), torch.from_numpy(d),
                  torch.from_numpy(g_sigma), torch.from_numpy(g_rgb), kind="bwd_feat")
    heads = _jax_heads(ws, feat, d)
    _, vjp = jax.vjp(lambda f: (lambda s, g, r: (s, r))(*heads(f)), jnp.asarray(feat))
    (want,) = vjp((jnp.asarray(g_sigma), jnp.asarray(g_rgb)))
    want = np.asarray(want)
    err = np.linalg.norm(got.numpy().astype(np.float64) - want) / np.linalg.norm(want)
    assert err <= 1e-5
    assert not bool(got[torch.from_numpy(dead)].any())


# the full backward's cases: (samples in tiles, blocks, which are dead)
BWD_CASES = {
    # a ragged last chunk and last tile: 5 tiles and 37 samples, a third dead
    "ragged": (5 * 128 + 37, 3, lambda i: i % 3 == 0),
    # chunk 1 all dead, and block 0's whole first round (chunks 0, 2, ...,
    # 30: samples 0-31, 64-95, ...), the rest mixed
    "dead_chunk": (40 * 32, 2, lambda i: (i % 5 == 1) | ((i // 32) % 2 == 0) & (i < 1024)
                   | ((i >= 32) & (i < 64))),
    # 3 live samples on 5 blocks: most blocks sum nothing
    "few_live": (6 * 128 + 1, 5, lambda i: ~np.isin(i, [5, 300, 700])),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("widths", _cuda.FIELD_WIDTHS)
def test_bwd_plan_matches_jax_vjp(widths, case):
    """field_bwd's plan over a grid of several blocks against JAX's VJP of
    _sigma_head / ngp_color, in feat and in each of the five weight leaves;
    g_feat exactly 0 on the dead samples."""
    assert t_ngp.SIMT_TILE["bwd"] == 128
    M, blocks, dead_of = BWD_CASES[case]
    ws = _weights(widths, 5)
    feat, d = _inputs(widths, M, 6)
    rng = np.random.default_rng(7)
    g_sigma = rng.standard_normal(M).astype(np.float32) * 1e-3
    g_rgb = rng.standard_normal((M, 3)).astype(np.float32) * 1e-3
    dead = dead_of(np.arange(M))
    g_sigma[dead], g_rgb[dead] = 0.0, 0.0
    flat = torch.cat([torch.from_numpy(w).reshape(-1) for w in ws])
    g_feat, g_flat = emulate(flat, widths, torch.from_numpy(feat), torch.from_numpy(d),
                             torch.from_numpy(g_sigma), torch.from_numpy(g_rgb), kind="bwd",
                             blocks=blocks)
    jcfg = j_ngp.NGPConfig(compute_dtype=jnp.float32)

    def heads(f, w):
        pj = {"sigma_net": list(w[:2]), "color_net": list(w[2:])}
        sigma, geo = j_ngp._sigma_head(pj, jcfg, f)
        return sigma, j_ngp.ngp_color(pj, jcfg, jnp.asarray(d), geo)

    _, vjp = jax.vjp(heads, jnp.asarray(feat), [jnp.asarray(w) for w in ws])
    want_feat, want_ws = vjp((jnp.asarray(g_sigma), jnp.asarray(g_rgb)))
    got_ws = _split(g_flat, widths)
    for got, want in [(g_feat, want_feat)] + list(zip(got_ws, want_ws)):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got.numpy().astype(np.float64) - want) / np.linalg.norm(want)
        assert err <= 1e-5
    assert not bool(g_feat[torch.from_numpy(dead)].any())


def wgrad_tile(T, K, J):
    """field_common.cuh:WgradTile's map: per thread, its (k, j) entries."""
    JG = (8 if K >= 64 else 16) if J >= 64 else 4
    KG = T // JG
    RK, RJ = -(-K // KG), -(-J // JG)
    for tid in range(T):
        jg, kg = tid % JG, tid // JG
        yield tid, [kg + KG * i for i in range(RK)], [jg + JG * jj for jj in range(RJ)]


# the weight gradients field_bwd sums: (K, J) of Ws0, Ws1, Wc0, Wc1, Wc2
WGRADS = sorted({(k, j) for w in _cuda.FIELD_WIDTHS
                 for k, j in ((w[0], w[1]), (w[1], w[2]), (15 + w[2], w[3]), (w[3], w[3]),
                              (w[3], 3))})


@pytest.mark.parametrize("K,J", WGRADS)
def test_wgrad_tile_owns_each_weight_once(K, J):
    """Each dW[k][j] has one owner, no thread reaches past the buffers'
    rows, and each quarter-warp's float4 loads of a sample step read one
    address or rows whose 16 bytes fall in distinct banks (rows BWD_LD
    floats apart)."""
    T, LD = t_ngp.SIMT_TILE["bwd"], t_ngp.BWD_LD
    seen = np.zeros((K, J), np.int64)
    rows_k, rows_j = {}, {}
    for tid, ks, js in wgrad_tile(T, K, J):
        for k in ks:
            for j in js:
                if k < K and j < J:
                    seen[k, j] += 1
        rows_k[tid] = [k for k in ks if k < K]
        rows_j[tid] = [j for j in js if j < J]
    assert (seen == 1).all()
    assert max(max(r, default=0) for r in rows_k.values()) < 64
    for q in range(T // 8):  # quarter-warps
        lanes = range(8 * q, 8 * q + 8)
        for rows in (rows_k, rows_j):
            for i in range(max(len(rows[t]) for t in lanes)):
                addrs = {rows[t][i] * LD for t in lanes if i < len(rows[t])}
                banks = [(a // 4) % 8 for a in addrs]  # a float4's group of 4 banks
                assert len(banks) == len(set(banks))
