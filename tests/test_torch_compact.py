"""K5, sample compaction: the port's plain version against the JAX
package's inline compaction (``render/renderer.py:render_rays_occ``), the
wrapper's CPU route, and the kernel's design emulated on the CPU (its
three-pass tile scan and its gather backward through the inverse slot map)
against the plain version on ``kernel_cases.k5_edge_inputs``.  The kernel
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


def emulate_pack(mask, xyzs, rays_d, Mc, tile=1024, items=4):
    """``csrc/compact.cu``'s pack step by step in numpy: per-tile counts,
    their exclusive scan, each thread's ``items`` consecutive samples ranked
    by the block's scan of its threads' counts, the empty slots [min(total,
    Mc), Mc) cleared by the threads of the same index."""
    N, S = mask.shape
    M = N * S
    flat = mask.reshape(-1)
    nb = -(-M // tile)
    counts = np.array([flat[b * tile:(b + 1) * tile].sum() for b in range(nb)], np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    xyz_c = np.full((Mc, 3), np.nan, np.float32)
    dir_c = np.full((Mc, 3), np.nan, np.float32)
    slot_of = np.full((M,), -7, np.int32)
    sample_of = np.full((Mc,), -7, np.int32)
    n_kept = min(int(offsets[nb]), Mc)
    for b in range(-(-max(M, Mc) // tile)):
        base = b * tile + np.arange(tile // items)[:, None] * items + np.arange(items)
        on = (base < M) & flat[np.minimum(base, max(M - 1, 0))] if M else np.zeros_like(base,
                                                                                   bool)
        c = on.sum(1)
        rank = np.cumsum(c) - c + (offsets[b] if b < nb else 0)
        for t in range(tile // items):
            r = rank[t]
            for k in range(items):
                i = base[t, k]
                if i < M:
                    slot = -1
                    if on[t, k]:
                        if r < Mc:
                            slot = r
                            xyz_c[r] = xyzs.reshape(-1, 3)[i]
                            dir_c[r] = rays_d[i // S]
                            sample_of[r] = i
                        r += 1
                    slot_of[i] = slot
                if n_kept <= i < Mc:
                    xyz_c[i] = 0.0
                    dir_c[i] = 0.0
                    sample_of[i] = -1
    return xyz_c, dir_c, slot_of, sample_of


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_pack_design_matches_the_plain_version(name):
    """The emulated tile scan writes every slot and every sample, and agrees
    bit for bit with the plain version's slots and maps."""
    _, mask, xyzs, rd, Mc, *_ = CASES[name]
    xyz_c, dir_c, slot_of, sample_of = emulate_pack(mask, xyzs, rd, Mc)
    comp = t_compact.compact_plain(T(mask), T(xyzs), T(rd), Mc)
    so, sa = t_compact.slot_maps_plain(comp)
    assert np.array_equal(slot_of, so.numpy()) and np.array_equal(sample_of, sa.numpy())
    assert np.array_equal(xyz_c, comp.xyz_c.numpy()) and np.array_equal(dir_c, comp.dir_c.numpy())


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
