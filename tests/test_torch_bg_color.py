"""K8 as the whole background colour (``ops/background.py``): the plain
versions (``ngp_background``'s route on CPU tensors: the chain and its
autograd; the backward written out) against JAX's ``ngp_background``,
forward and ``jax.vjp`` for ``bg_table`` and both ``bg_net`` matrices, at
the tiny bg size of test_torch_background.py (2 levels of 2^10 rows); the
written-out backward against autograd of the chain; the bf16 limits
against a route without mlp_apply's bf16 roundings (which they refuse);
the packed weights against ``mlp_apply``'s casts; the rays at bg_net's
ReLU kink, which the card's fp32 checks leave out; the geometry the kernels
refuse; ``BackgroundFn``'s gradients, none and no backward for frozen
leaves (its kernels stood in for by the plain versions).  The kernels
themselves are held against these plain versions on the card
(tests/test_torch_kernels.py, ``-k bg``).

Tolerances (measured on this file's inputs, rays at phi's branch cut left
out as in test_torch_background.py):
  * fp32: the colour atol 1e-5 (measured 1.3e-6), each gradient 1e-5
    relative L2 (measured 2.2e-6): XLA's sum order and fusions.
  * bf16 (JAX eager: a jitted program keeps excess bf16 precision): the
    colour atol 1e-6 (measured 6e-8), each gradient 1e-4 relative L2
    (measured 1.2e-5: an entry a bf16 step apart where an fp32 sum rounds
    the other way).  The control, the same chain without the activations'
    bf16 roundings (or all in fp32), misses by ten times these limits or
    more (``test_bf16_limits_refuse_a_route_without_the_roundings``).
  * ``background_bwd_plain`` against autograd of ``background_plain``: bit
    for bit (the same ops in the same order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu_torch.models import mlp as t_mlp
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import background as t_bg
from nerf_signature_tpu_torch.ops import hashenc as t_hash
from test_torch_train_ops import one_torch_thread, rel_l2  # noqa: F401

T = torch.from_numpy
BG = dict(bg_radius=8.0, bg_n_levels=2, bg_log2_hashmap_size=10, bg_finest_resolution=64)
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
N_RAYS = 400
FEATURES = (2, 4)
FWD_ATOL = {"fp32": 1e-5, "bf16": 1e-6}
GRAD_REL = {"fp32": 1e-5, "bf16": 1e-4}


def _inputs(F, seed=7):
    """Rays from inside the sphere, a U(+-1) table, He-uniform bg_net
    weights and a cotangent of the colour, as numpy."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(N_RAYS, 3)) * 1.5).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    table = rng.uniform(-1, 1, size=(2 << 10, F)).astype(np.float32)
    IN = 2 * F + 16
    w1 = (rng.uniform(-1, 1, size=(IN, 64)) * np.sqrt(6 / IN)).astype(np.float32)
    w2 = (rng.uniform(-1, 1, size=(64, 3)) * np.sqrt(6 / 64)).astype(np.float32)
    g = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    return dict(o=o, d=d, table=table, w1=w1, w2=w2, g=g)


def _cfg(F, dtype):
    return t_ngp.NGPConfig(n_features=F, compute_dtype=DT[dtype][1], **BG)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's colour and its VJP for bg_table and bg_net, per (F, dtype)."""
    out = {}
    for F in FEATURES:
        a = _inputs(F)
        for dtype in DT:
            jcfg = j_ngp.NGPConfig(n_features=F, compute_dtype=DT[dtype][0], **BG)

            def colour(p, jcfg=jcfg):
                return j_ngp.ngp_background(p, jcfg, jnp.asarray(a["o"]), jnp.asarray(a["d"]))

            p = {"bg_table": jnp.asarray(a["table"]),
                 "bg_net": [jnp.asarray(a["w1"]), jnp.asarray(a["w2"])]}
            c, vjp = jax.vjp(jax.jit(colour) if dtype == "fp32" else colour, p)
            (g,) = vjp(jnp.asarray(a["g"]))
            out[F, dtype] = (np.asarray(c), [np.asarray(g["bg_table"])]
                             + [np.asarray(w) for w in g["bg_net"]])
    return out


def _leaves(a):
    return [T(a[k].copy()).requires_grad_(True) for k in ("table", "w1", "w2")]


def _colour(a, leaves, cfg):
    """ngp_background on CPU tensors: the plain chain, through autograd."""
    table, w1, w2 = leaves
    return t_ngp.ngp_background({"bg_table": table, "bg_net": [w1, w2]}, cfg, T(a["o"]),
                                T(a["d"]))


@pytest.mark.parametrize("F", FEATURES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_background_plain_matches_jax(jax_ref, dtype, F):
    """The colour and its gradients (autograd of the chain, and the
    backward written out) against JAX's colour and jax.vjp."""
    a, cfg = _inputs(F), _cfg(F, dtype)
    cut = t_hash.sphere_cut(T(a["o"]), T(a["d"]), BG["bg_radius"]).numpy()
    leaves = _leaves(a)
    c = _colour(a, leaves, cfg)
    cj, gj = jax_ref[F, dtype]
    assert c.shape == (N_RAYS, 3) and ((c > 0) & (c < 1)).all()
    np.testing.assert_allclose(c.detach().numpy()[~cut], cj[~cut], rtol=0, atol=FWD_ATOL[dtype])
    c.backward(T(a["g"]))
    assert not cut.any()  # no ray of these inputs at phi's cut: the gradients whole
    written = t_bg.background_bwd_plain(T(a["o"]), T(a["d"]), T(a["table"]),
                                        [T(a["w1"]), T(a["w2"])], T(a["g"]), t_ngp.bg_meta(cfg))
    for name, leaf, w, ref in zip(("bg_table", "w1", "w2"), leaves, written, gj):
        for g in (leaf.grad, w):
            assert g.shape == ref.shape
            assert rel_l2(g.numpy(), ref) <= GRAD_REL[dtype], (name, rel_l2(g.numpy(), ref))


@pytest.mark.parametrize("F", FEATURES)
@pytest.mark.parametrize("route", ["fp32", "unrounded activations"])
def test_bf16_limits_refuse_a_route_without_the_roundings(jax_ref, route, F):
    """The bf16 limits tell mlp_apply's bf16 roundings from their absence:
    the chain in fp32 on the fp32 leaves, or in fp32 on the bf16-rounded
    table and weights (only the activations' roundings skipped), misses
    JAX's bf16 colour and gradients by ten times the limits or more."""
    a, cfg = _inputs(F), _cfg(F, "fp32")
    leaves = _leaves(a)
    if route != "fp32":
        leaves = [t.detach().to(torch.bfloat16).float().requires_grad_(True) for t in leaves]
    c = _colour(a, leaves, cfg)
    c.backward(T(a["g"]))
    cj, gj = jax_ref[F, "bf16"]
    assert float(np.abs(c.detach().numpy() - cj).max()) > 10 * FWD_ATOL["bf16"]
    for leaf, ref in zip(leaves, gj):
        assert rel_l2(leaf.grad.numpy(), ref) > 10 * GRAD_REL["bf16"]


@pytest.mark.parametrize("F", FEATURES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_background_bwd_plain_is_the_chains_autograd(dtype, F):
    """The written-out backward (the kernel's steps and roundings) equals
    autograd through the chain bit for bit; the forward equals
    ngp_background's plain route."""
    a, cfg = _inputs(F, seed=8), _cfg(F, dtype)
    meta = t_ngp.bg_meta(cfg)
    leaves = _leaves(a)
    c = t_bg.background_plain(T(a["o"]), T(a["d"]), leaves[0], leaves[1:], meta)
    c.backward(T(a["g"]))
    got = t_bg.background_bwd_plain(T(a["o"]), T(a["d"]), T(a["table"]), [T(a["w1"]),
                                    T(a["w2"])], T(a["g"]), meta)
    for leaf, g in zip(leaves, got):
        assert g.dtype == torch.float32 and torch.equal(leaf.grad, g)
    params = {"bg_table": T(a["table"]), "bg_net": [T(a["w1"]), T(a["w2"])]}
    plain = t_ngp.ngp_background(params, cfg, T(a["o"]), T(a["d"]))
    assert torch.equal(plain, c.detach())


@pytest.mark.parametrize("F", FEATURES)
def test_rays_at_the_relu_kink_move_w1_and_the_table_not_w2(F):
    """relu_margin is each ray's least |pre-activation| of mlp_apply's first
    layer.  A unit of the ray nearest the kink set 1e-5 above 0, then 1e-5
    below (a shift of its SH DC weight: every ray's unit moves alike) moves
    the table's and W1's gradients by more than 1e-3 relative L2 and W2's by
    less than 1e-5; both rays sit under the checks' margin (1e-4:
    chip_smoke.py BG_KINK), and with the rays under it given no cotangent
    the two gradients agree within 1e-5.  (Measured at F = 2 and 4: the
    table 6.0e-3 and 1.3e-2, W1 8.5e-3 and 1.4e-2, W2 4.4e-6 and 1.9e-6.)"""
    from nerf_signature_tpu_torch.ops.sh import sh_encode

    a, cfg = _inputs(F), _cfg(F, "fp32")
    meta = t_ngp.bg_meta(cfg)
    o, d, table, g = T(a["o"]), T(a["d"]), T(a["table"]), T(a["g"])
    w1, w2 = T(a["w1"]), T(a["w2"])
    h2 = t_hash.bg_encode(o, d, meta.radius, table, meta.resolutions, meta.log2_hashmap_size,
                          plain=True)
    x = torch.cat([h2, sh_encode(d / torch.linalg.norm(d, dim=-1, keepdim=True), 4)], dim=-1)
    pre = t_mlp.mlp_apply([w1], x, compute_dtype=torch.float32)
    margin = t_bg.relu_margin(o, d, table, [w1, w2], meta)
    assert margin.shape == (N_RAYS,) and torch.equal(margin, pre.abs().amin(dim=-1))
    r = int(margin.argmin())
    j = int(pre[r].abs().argmin())
    dc = 2 * F  # the SH DC input, the same for every ray
    grads, margins = [], []
    for side in (1.0, -1.0):
        w1s = w1.clone()
        w1s[dc, j] += (side * 1e-5 - float(pre[r, j])) / float(x[r, dc])
        assert float(torch.sign((x @ w1s)[r, j])) == side
        margins.append(t_bg.relu_margin(o, d, table, [w1s, w2], meta))
        grads.append((w1s, t_bg.background_bwd_plain(o, d, table, [w1s, w2], g, meta)))
    assert all(float(m[r]) < 1e-4 for m in margins)
    (_, ga), (_, gb) = grads
    assert rel_l2(ga[0].numpy(), gb[0].numpy()) > 1e-3
    assert rel_l2(ga[1].numpy(), gb[1].numpy()) > 1e-3
    assert rel_l2(ga[2].numpy(), gb[2].numpy()) < 1e-5
    kept = g.clone()
    kept[(margins[0] < 1e-4) | (margins[1] < 1e-4)] = 0.0
    assert int((kept == 0).all(-1).sum()) <= N_RAYS // 10
    ga, gb = (t_bg.background_bwd_plain(o, d, table, [w, w2], kept, meta) for w, _ in grads)
    for u, v in zip(ga, gb):
        assert rel_l2(u.numpy(), v.numpy()) < 1e-5


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_packed_weights_are_mlp_applys_casts(dtype):
    """pack_bg_net: W1 then W2, flat fp32, each weight rounded to the
    compute dtype as mlp_apply's ``w.to(compute_dtype)`` rounds it; so an
    fp32 matmul on the packed weights and a rounded input equals
    mlp_apply's first layer before its output rounding."""
    a, cfg = _inputs(2), _cfg(2, dtype)
    cd = cfg.compute_dtype
    w1, w2 = T(a["w1"]), T(a["w2"])
    packed = t_bg.pack_bg_net([w1.requires_grad_(True), w2], cd)
    assert packed.dtype == torch.float32 and not packed.requires_grad
    assert packed.shape == (a["w1"].size + a["w2"].size,)
    n1 = a["w1"].size
    assert torch.equal(packed[:n1].view(w1.shape), w1.detach().to(cd).float())
    assert torch.equal(packed[n1:].view(w2.shape), w2.to(cd).float())
    if dtype == "bf16":
        assert not torch.equal(packed[:n1].view(w1.shape), w1.detach())
    x = torch.randn((16, w1.shape[0]), generator=torch.Generator().manual_seed(0))
    layer = t_mlp.mlp_apply([w1.detach()], x, compute_dtype=cd)
    mine = (x.to(cd).float() @ packed[:n1].view(w1.shape)).to(cd).float()
    torch.testing.assert_close(mine, layer, rtol=0, atol=0 if dtype == "fp32" else 2e-2)


@pytest.mark.parametrize("change", [{}, dict(bg_hidden_dim=32), dict(bg_num_layers=3),
                                    dict(n_features=3), dict(bg_n_levels=40),
                                    dict(bg_n_levels=8, n_features=8), dict(sh_degree=3)])
def test_bg_geometry_outside_the_build_is_refused(change):
    """check_kernel_geometry refuses, before anything runs on the card, a
    bg model the kernels are not built for (a bg_net other than IN -> 64 ->
    3, F outside {1, 2, 4, 8}, more than 32 bg levels); the defaults and 8
    bg levels of 8 features run (the field at 8 levels: width 64 at F = 8)."""
    cfg = dataclasses.replace(t_ngp.NGPConfig(bg_radius=8.0, n_levels=8), **change)
    ok = not change or change == dict(bg_n_levels=8, n_features=8)
    if ok:
        t_ngp.check_kernel_geometry(cfg)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        t_ngp.check_kernel_geometry(cfg)
    if "bg_hidden_dim" not in change and "bg_num_layers" not in change:
        # the kernels' own arguments refuse it too (the wrappers' last check)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
            t_bg.kernel_args(t_ngp.bg_meta(cfg), cfg.n_features)
    # without the bg model the field alone decides
    if "n_features" not in change and "sh_degree" not in change:
        t_ngp.check_kernel_geometry(dataclasses.replace(cfg, bg_radius=-1.0))


def test_kernel_args_are_built_once_per_geometry():
    """The static arguments (levels, r^2, the backward's tile) come from
    one cached build per geometry; the widest geometry
    (32 levels x 8 features) takes the backward in tiles of 64 rays."""
    meta = t_ngp.bg_meta(t_ngp.NGPConfig(bg_radius=8.0))
    a = t_bg.kernel_args(meta, 2)
    assert t_bg.kernel_args(meta, 2) is a and t_ngp.bg_meta(t_ngp.NGPConfig(bg_radius=8.0)) is meta
    assert (a.L, a.F, a.IN, a.n_weights, a.tile) == (4, 2, 24, 24 * 64 + 192, 128)
    assert a.r2 == 64.0 and list(a.res) == list(meta.resolutions)
    wide = t_bg.kernel_args(meta._replace(resolutions=(16.0,) * 32), 8)
    assert (wide.IN, wide.tile) == (272, 64)


def _kernels_as_plain(monkeypatch, calls):
    """BackgroundFn's kernels stood in for by their plain versions (the
    table from the gathered copy, the weights from the packed buffer), the
    backward's calls counted."""
    def unpack(packed, meta, F):
        n1 = (len(meta.resolutions) * F + 16) * 64
        return [packed[:n1].view(-1, 64), packed[n1:].view(64, 3)]

    def fwd(o, d, table_g, packed, meta):
        net = unpack(packed, meta, table_g.shape[-1])
        return t_bg.background_plain(o, d, table_g.float(), net, meta, table_g)

    def bwd(o, d, table_g, packed, g, n_rows, meta):
        calls.append(1)
        net = unpack(packed, meta, table_g.shape[-1])
        return t_bg.background_bwd_plain(o, d, table_g.float(), net, g, meta, table_g)

    monkeypatch.setattr(t_bg, "bg_color_kernel", fwd)
    monkeypatch.setattr(t_bg, "_bg_color_bwd_kernel", bwd)


def _apply(a, leaves, cfg):
    table, w1, w2 = leaves
    cd = cfg.compute_dtype
    return t_bg.BackgroundFn.apply(T(a["o"]), T(a["d"]), table, w1, w2, table.detach().to(cd),
                                   t_bg.pack_bg_net([w1, w2], cd), t_ngp.bg_meta(cfg))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_background_fn_gradients_are_its_backwards(monkeypatch, dtype):
    """BackgroundFn's gradients for the table and both matrices are what
    its backward returns (the written-out plain backward standing in for
    the kernels); the rays get none."""
    calls = []
    _kernels_as_plain(monkeypatch, calls)
    a, cfg = _inputs(2), _cfg(2, dtype)
    leaves = _leaves(a)
    c = _apply(a, leaves, cfg)
    assert torch.equal(c.detach(), t_bg.background_plain(T(a["o"]), T(a["d"]), T(a["table"]),
                                                         [T(a["w1"]), T(a["w2"])],
                                                         t_ngp.bg_meta(cfg)))
    c.backward(T(a["g"]))
    want = t_bg.background_bwd_plain(T(a["o"]), T(a["d"]), T(a["table"]),
                                     [T(a["w1"]), T(a["w2"])], T(a["g"]), t_ngp.bg_meta(cfg))
    assert calls == [1]
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_frozen_bg_leaves_get_no_gradient_and_no_backward(monkeypatch):
    """Frozen bg leaves (the watermark stage's backbone): the colour needs
    no gradient and no backward runs; with only the table trainable, the
    matrices get None."""
    calls = []
    _kernels_as_plain(monkeypatch, calls)
    a, cfg = _inputs(2), _cfg(2, "fp32")
    frozen = [T(a[k].copy()) for k in ("table", "w1", "w2")]
    c = _apply(a, frozen, cfg)
    assert not c.requires_grad and calls == []
    table = T(a["table"].copy()).requires_grad_(True)
    x = torch.zeros((N_RAYS, 3), requires_grad=True)  # another leaf of the loss
    loss = (_apply(a, [table] + frozen[1:], cfg) * T(a["g"])).sum() + x.sum()
    loss.backward()
    assert calls == [1] and table.grad is not None and table.grad.abs().sum() > 0
    assert frozen[1].grad is None and frozen[2].grad is None
    # nothing of the bg model trainable: no backward at all
    calls.clear()
    loss = (_apply(a, frozen, cfg) * T(a["g"])).sum() + x.sum()
    loss.backward()
    assert calls == []


def test_background_fn_refuses_cpu_tensors():
    """BackgroundFn is the card's wrapper: on CPU tensors its kernel raises
    (ngp_background sends those to the plain chain before it)."""
    a, cfg = _inputs(2), _cfg(2, "fp32")
    with pytest.raises(ValueError, match="CUDA"):
        _apply(a, _leaves(a), cfg)
