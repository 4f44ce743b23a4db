"""K5, sample compaction: the port's plain version against the JAX
package's inline compaction (``render/renderer.py:render_rays_occ``), the
wrapper's CPU route, and the kernel's design emulated on the CPU (its
single-pass pack with a decoupled look-back, under several orders of its
tiles, and its gather backward through the inverse slot map) against the
plain version on ``kernel_cases.k5_edge_inputs``.  The kernel
itself runs on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).

Tolerances and why:
  * render with compaction, port against JAX: the port's renderer marches
    with JAX's ``march_rays`` (``test_torch_wm_train.jax_march_into_port``),
    so both compact the very same samples, and the field is an analytic one
    (a softplus density and sigmoid colour of linear maps).  n_occupied is
    equal; the image and the gradients at the slots (zero probes added to
    the field's outputs) agree within 1e-6 relative (atol 1e-6 and 1e-7:
    the compositor's sums in another order); the gradients of the field's
    weights, sums over thousands of slots in another order, within 1e-5
    relative L2 (measured on the CPU: 1.1e-6).  With Mc below the
    occupied count, samples of rank >= Mc are dropped by both.
  * everything else is a copy: bit-equal (``torch.equal``).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.render import renderer as j_render
from nerf_signature_tpu_torch import kernel_cases
from nerf_signature_tpu_torch.ops import compact as t_compact
from nerf_signature_tpu_torch.render import renderer as t_render
from test_torch_render import ball_occupancy, view_rays
from test_torch_train_ops import rel_l2
from test_torch_wm_train import jax_march_into_port

T = torch.from_numpy
CASES = {c[0]: c for c in kernel_cases.k5_edge_inputs()}


def unpack_bwd_gather(g_sig, g_rgb, sample_of):
    """K5's unpack backward (``csrc/compact.cu``) written in PyTorch: a
    gather of (g_sigmas [M], g_rgbs [M, 3]) through ``sample_of`` [Mc]
    (zero for an empty slot)."""
    live = sample_of >= 0
    src = torch.clamp(sample_of, min=0).long()
    return (torch.where(live, g_sig[src], 0.0),
            torch.where(live[:, None], g_rgb[src], 0.0))


def _field_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3,)).astype(np.float32) * 3,
            "B": rng.normal(size=(3, 3)).astype(np.float32),
            "C": rng.normal(size=(3, 3)).astype(np.float32)}


def _jax_field(p):
    """The analytic field plus zero probes ``ps``/``pr`` on its outputs: their
    gradients are the loss's gradients at the slots."""
    def f(x, d):
        return (jax.nn.softplus(x @ p["a"] + 1.0) * 10.0 + p["ps"],
                jax.nn.sigmoid(x @ p["B"] + d @ p["C"]) + p["pr"])
    return f


def _torch_field(p):
    def f(x, d):
        return (torch.nn.functional.softplus(x @ p["a"] + 1.0) * 10.0 + p["ps"],
                torch.sigmoid(x @ p["B"] + d @ p["C"]) + p["pr"])
    return f


@pytest.mark.parametrize("frac,drops", [(0.75, False), (0.25, True)])
def test_render_with_compaction_matches_jax(monkeypatch, frac, drops):
    jax_march_into_port(monkeypatch)
    rays = view_rays(1.0, n=1, res=12, seed=2)
    ro, rd = rays["rays_o"][0][:128], rays["rays_d"][0][:128]
    occ = ball_occupancy(1.0, H=32, radius=0.7)
    kw = dict(bound=1.0, grid_size=32, max_steps=128, min_near=0.05, compact_frac=frac)
    rc_j, rc_t = j_render.RenderConfig(**kw), t_render.RenderConfig(**kw)
    Mc = int(np.ceil(128 * 32 * frac / 1024.0)) * 1024
    p = dict(_field_params(), ps=np.zeros((Mc,), np.float32), pr=np.zeros((Mc, 3), np.float32))

    def loss_j(pj):
        out = j_render.render_rays_occ(_jax_field(pj), jnp.asarray(occ), jnp.asarray(ro),
                                       jnp.asarray(rd), rc_j, budget=32)
        return jnp.sum(out["image"] * jnp.arange(1.0, 4.0)), out

    (lj, oj), gj = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p))
    pt = {k: T(v).requires_grad_() for k, v in p.items()}
    ot = t_render.render_rays_occ(_torch_field(pt), T(occ), T(ro), T(rd), rc_t, budget=32)
    (ot["image"] * torch.arange(1.0, 4.0)).sum().backward()

    n_occ = np.asarray(oj["n_occupied"])
    assert np.array_equal(ot["n_occupied"].numpy(), n_occ)
    assert (n_occ.sum() > Mc) == drops
    np.testing.assert_allclose(ot["image"].detach().numpy(), np.asarray(oj["image"]),
                               rtol=1e-6, atol=1e-6)
    for k in ("ps", "pr"):  # at the slots
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(gj[k]), rtol=1e-6,
                                   atol=1e-7)
    for k in ("a", "B", "C"):  # sums over every slot
        assert rel_l2(pt[k].grad.numpy(), np.asarray(gj[k])) <= 1e-5, k


def _old_render_compaction(mask, xyzs, dirs, Mc, field_fn):
    """The renderer's compaction as it stood before K5 (for the backward)."""
    flat_mask = mask.reshape(-1)
    rank = torch.cumsum(flat_mask.to(torch.int64), dim=0) - 1
    keep = flat_mask & (rank < Mc)
    dst = torch.where(keep, rank, Mc)
    xyz_c = torch.zeros((Mc + 1, 3), dtype=xyzs.dtype)
    xyz_c[dst] = xyzs.reshape(-1, 3)
    dir_c = torch.zeros((Mc + 1, 3), dtype=dirs.dtype)
    dir_c[dst] = dirs.reshape(-1, 3)
    sig_c, rgb_c = field_fn(xyz_c[:Mc].contiguous(), dir_c[:Mc].contiguous())
    src = torch.clamp(rank, 0, Mc - 1)
    return torch.where(keep, sig_c[src], 0.0), torch.where(keep[:, None], rgb_c[src], 0.0)


def _case(name):
    _, mask, xyzs, rd, Mc, sig_c, rgb_c, g_sig, g_rgb = CASES[name]
    return (T(mask), T(xyzs), T(rd), Mc, T(sig_c), T(rgb_c), T(g_sig), T(g_rgb))


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_wrapper_is_the_plain_version_with_autograds_backward(name):
    mask, xyzs, rd, Mc, sig_c, rgb_c, g_sig, g_rgb = _case(name)
    comp = t_compact.compact(mask, xyzs, rd, Mc)
    assert comp.slot_of is None and comp.keep is not None  # the CPU route
    N, S = mask.shape
    dirs = rd[:, None, :].expand(N, S, 3)
    leaves = [sig_c.clone().requires_grad_(), rgb_c.clone().requires_grad_()]
    old = [sig_c.clone().requires_grad_(), rgb_c.clone().requires_grad_()]
    seen = {}

    def field(x, d):
        seen["x"], seen["d"] = x, d
        return old[0] * 1.0, old[1] * 1.0

    so, ro = _old_render_compaction(mask, xyzs, dirs, Mc, field)
    sn, rn = t_compact.uncompact(leaves[0], leaves[1], comp)
    assert torch.equal(comp.xyz_c, seen["x"]) and torch.equal(comp.dir_c, seen["d"])
    assert torch.equal(sn, so) and torch.equal(rn, ro)
    if sn.numel():
        ((so * g_sig).sum() + (ro * g_rgb).sum()).backward()
        ((sn * g_sig).sum() + (rn * g_rgb).sum()).backward()
        assert torch.equal(leaves[0].grad, old[0].grad)
        assert torch.equal(leaves[1].grad, old[1].grad)


# csrc/compact.cu's pack: threads a block, samples a thread (one uint4 of
# mask), rays a tile stages, and a tile's status flags
PACK_THREADS, PACK_ITEMS, RAY_CAP = 128, 16, 256
AGGREGATE, INCLUSIVE = 1, 2


def store_run(q0, q1):
    """The positions ``csrc/compact.cu:store_run`` writes over [q0, q1) of
    a 16-byte aligned array: a scalar head up to the first group of 4, the
    groups of 4 (one float4 / int4 each), a scalar tail; all scalars where
    the range holds no whole group."""
    a0, a1 = (q0 + 3) & ~3, q1 & ~3
    if a0 >= a1:
        return np.arange(q0, q1)
    groups = (np.arange(a0 // 4, a1 // 4)[:, None] * 4 + np.arange(4)).reshape(-1)
    return np.concatenate([np.arange(q0, a0), np.arange(a1, q1), groups])


def emulate_pack(mask, xyzs, rays_d, Mc, order):
    """``csrc/compact.cu``'s pack step by step in numpy: the single pass
    over tiles of ``PACK_TILE`` samples (positions and rays staged as the
    kernel stages them, slot_of by groups of 4 samples) with a decoupled
    look-back, then the launch that clears the empty slots.  Tiles start in the order of their
    ids (the atomicAdd counter) and then run interleaved as ``order`` picks:
    ``("seed", k)`` a random runnable tile from a generator seeded with k,
    ``"newest_first"`` the runnable tile of highest id (every tile publishes
    its count before tile 0's prefix, so the look-backs walk whole windows
    of 32 counts).  A tile whose look-back finds a needed predecessor
    unpublished waits until some status word changes.  Every output element
    is counted as it is written; returns the outputs and those counts."""
    N, S = mask.shape
    M = N * S
    tile = t_compact.PACK_TILE
    flat, xyz_flat, rd_flat = mask.reshape(-1), xyzs.reshape(-1), rays_d.reshape(-1)
    nt = -(-M // tile)
    flag = np.zeros((nt,), np.int64)
    value = np.zeros((nt,), np.int64)
    out = {"xyz_c": np.full((3 * Mc,), np.nan, np.float32),
           "dir_c": np.full((3 * Mc,), np.nan, np.float32),
           "slot_of": np.full((M,), -7, np.int32), "sample_of": np.full((Mc,), -7, np.int32)}
    writes = {k: np.zeros(v.shape, np.int64) for k, v in out.items()}
    changed = [False]

    def write(name, pos, vals):
        out[name][pos] = vals
        np.add.at(writes[name], pos, 1)

    def publish(b, f, v):
        flag[b], value[b] = f, v
        changed[0] = True

    def run_tile(b):
        """One block's steps; yields whether the step got anywhere."""
        base = b * tile + np.arange(PACK_THREADS)[:, None] * PACK_ITEMS + np.arange(PACK_ITEMS)
        on = (base < M) & flat[np.minimum(base, M - 1)]
        c = on.sum(1)
        lr = np.cumsum(c) - c  # the block's exclusive scan of the threads' counts
        agg = int(c.sum())
        sidx = base[on]  # staged in rank order
        # the staged positions: each float4 of the tile's positions that
        # touches a set sample (the rest never read: NaN here), and the
        # tile's rays where they fit (RAY_CAP)
        start, length = b * tile, min(tile, M - b * tile)
        g = np.arange(3 * tile // 4)
        touch = on.reshape(-1)[4 * g // 3] | on.reshape(-1)[(4 * g + 3) // 3]
        q = (g[touch][:, None] * 4 + np.arange(4)).reshape(-1)
        q = q[q < 3 * length]
        sxyz = np.full((3 * tile,), np.nan, np.float32)
        sxyz[q] = xyz_flat[3 * start + q]
        r0, nr = start // S, (start + length - 1) // S - start // S + 1
        sray = rd_flat[3 * r0:3 * (r0 + nr)] if nr <= RAY_CAP else None
        yield True
        excl = 0
        if b == 0:
            publish(0, INCLUSIVE, agg)
        else:
            publish(b, AGGREGATE, agg)
            yield True
            top = b - 1
            while True:  # one warp: lane l reads tile top - l
                p = top - np.arange(32)
                f = np.where(p >= 0, flag[np.maximum(p, 0)], INCLUSIVE)
                v = np.where(p >= 0, value[np.maximum(p, 0)], 0)
                incl = f == INCLUSIVE
                need = np.arange(32) <= (np.argmax(incl) if incl.any() else 31)
                if not (f[need] != 0).all():
                    yield False
                    continue
                excl += int(v[need].sum())
                if incl.any():
                    break
                top -= 32
                yield True
            publish(b, INCLUSIVE, excl + agg)
        yield True
        kept = max(0, min(agg, Mc - excl))
        # slot_of by groups of 4 samples: group g's owner thread g // 4, its
        # bits from 4 (g % 4)
        g = np.arange(tile // 4)
        owner, b0 = g // 4, 4 * (g % 4)
        bits = on[owner][:, None, :]  # [groups, 1, PACK_ITEMS]
        below = np.arange(PACK_ITEMS)[None, None, :] < (b0[:, None] + np.arange(4))[:, :, None]
        r = excl + lr[owner][:, None] + (bits & below).sum(-1)
        sample = start + 4 * g[:, None] + np.arange(4)
        set_ = on[owner][np.arange(len(g))[:, None], b0[:, None] + np.arange(4)]
        live = sample < M
        write("slot_of", sample[live], np.where(set_ & (r < Mc), r, -1)[live])
        q = store_run(3 * excl, 3 * (excl + kept))
        j, a = (q - 3 * excl) // 3, (q - 3 * excl) % 3
        write("xyz_c", q, sxyz[3 * (sidx[j] - start) + a])
        n = sidx[j] // S
        write("dir_c", q, rd_flat[3 * n + a] if sray is None else sray[3 * (n - r0) + a])
        q = store_run(excl, excl + kept)
        write("sample_of", q, sidx[q - excl])

    rng = np.random.default_rng(order[1]) if order != "newest_first" else None
    running, blocked, started = {}, set(), 0
    while running or started < nt:
        runnable = [b for b in running if b not in blocked] + ([started] if started < nt else [])
        assert runnable, "every running tile waits: the look-back deadlocked"
        b = max(runnable) if rng is None else runnable[rng.integers(len(runnable))]
        if b == started:
            running[b] = run_tile(b)
            started += 1
        changed[0] = False
        moved = next(running[b], None)
        if moved is None:
            del running[b]
        elif not moved:
            blocked.add(b)
        if changed[0]:
            blocked.clear()
    # the second launch: the empty slots, from the last tile's prefix
    assert (flag == INCLUSIVE).all()
    n_kept = min(int(value[-1]) if nt else 0, Mc)
    q = store_run(3 * n_kept, 3 * Mc)
    write("xyz_c", q, 0.0)
    write("dir_c", q, 0.0)
    write("sample_of", store_run(n_kept, Mc), -1)
    return out, writes


ORDERS = [("seed", 0), ("seed", 1), ("seed", 2), "newest_first"]


@pytest.mark.parametrize("order", ORDERS, ids=lambda o: o if isinstance(o, str) else f"seed{o[1]}")
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_pack_design_matches_the_plain_version(name, order):
    """The emulated single pass writes every slot and every sample exactly
    once, whatever order its tiles run in, and agrees bit for bit with the
    plain version's slots and maps."""
    _, mask, xyzs, rd, Mc, *_ = CASES[name]
    out, writes = emulate_pack(mask, xyzs, rd, Mc, order)
    assert all((w == 1).all() for w in writes.values())
    comp = t_compact.compact_plain(T(mask), T(xyzs), T(rd), Mc)
    so, sa = t_compact.slot_maps_plain(comp)
    assert np.array_equal(out["slot_of"], so.numpy())
    assert np.array_equal(out["sample_of"], sa.numpy())
    assert np.array_equal(out["xyz_c"], comp.xyz_c.numpy().reshape(-1))
    assert np.array_equal(out["dir_c"], comp.dir_c.numpy().reshape(-1))


def test_pack_tile_is_the_kernels():
    """The wrapper sizes the pack's scratch by the tile the kernel takes, and
    the emulation runs the kernel's threads, samples a thread and staged
    rays."""
    with open(os.path.join(os.path.dirname(t_compact.__file__), "..", "csrc",
                           "compact.cu")) as f:
        src = f.read()
    const = dict(re.findall(r"constexpr int (PACK_THREADS|PACK_ITEMS|RAY_CAP) = (\d+);", src))
    assert tuple(int(const[k]) for k in ("PACK_THREADS", "PACK_ITEMS", "RAY_CAP")) == (
        PACK_THREADS, PACK_ITEMS, RAY_CAP)
    assert "PACK_TILE = PACK_THREADS * PACK_ITEMS;" in src
    assert t_compact.PACK_TILE == PACK_THREADS * PACK_ITEMS


@pytest.mark.parametrize("name", list(CASES))
def test_gather_backward_equals_indexing_backward(name):
    """The kernel's backward (a gather through ``sample_of``) against
    autograd's indexing_backward of the plain unpack: bit-equal, since the
    plain sums add only zeros to the one live term."""
    mask, xyzs, rd, Mc, sig_c, rgb_c, g_sig, g_rgb = _case(name)
    comp = t_compact.compact_plain(mask, xyzs, rd, Mc)
    _, sample_of = t_compact.slot_maps_plain(comp)
    leaves = [sig_c.clone().requires_grad_(), rgb_c.clone().requires_grad_()]
    s, r = t_compact.uncompact_plain(leaves[0], leaves[1], comp)
    gs, gr = unpack_bwd_gather(g_sig, g_rgb, sample_of)
    if s.numel():
        ((s * g_sig).sum() + (r * g_rgb).sum()).backward()
        assert torch.equal(leaves[0].grad, gs) and torch.equal(leaves[1].grad, gr)
    assert gs.shape == (Mc,) and gr.shape == (Mc, 3)
    if name == "all_on_drop":
        assert int((sample_of >= 0).sum()) == Mc < mask.numel()
    if name == "last_only":
        assert int(sample_of[0]) == mask.numel() - 1 and int((sample_of >= 0).sum()) == 1
