"""Port parity of the backward passes: each differentiable op of
``nerf_signature_tpu_torch`` against ``jax.vjp`` of its JAX counterpart on
the same numpy inputs and cotangents (CPU: the plain backward versions; the
CUDA backward kernels are held against these in test_torch_kernels.py).

Errors are relative L2 over the whole gradient (``|a - b| / |b|``).
Tolerances and why:
  * hash encoder (K1), fp32 and bf16 gathers, hashed and dense layouts:
    1e-6.  The same corner weights and the same bf16 rounding of
    ``cw * g``; only the order of the fp32 scatter-adds differs.
  * compositor (K3): 1e-5.  Autograd of the same closed form; cumsums and
    exps round differently in XLA and PyTorch.
  * field heads (K4): fp32 1e-5 (summation order inside the matmuls); bf16
    1e-5 (measured 0: every activation and cotangent rounds to bf16 at the
    same points in both packages).
  * trunc_exp: 1e-6 elementwise, beyond the +-15 clamp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu.ops import activation as j_act
from nerf_signature_tpu.ops import composite as j_comp
from nerf_signature_tpu.ops import hashenc as j_hash
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import activation as t_act
from nerf_signature_tpu_torch.ops import composite as t_comp
from nerf_signature_tpu_torch.ops import hashenc as t_hash
from nerf_signature_tpu_torch.train.checkpoint import params_from_jax
from test_torch_field import jax_params, small_cfgs
from test_torch_ops import HASH_CASES, _composite_inputs, _hash_inputs

T = torch.from_numpy


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread for a module's tests (autouse where a test
    module imports it).  The Tier-1 run puts six workers on the machine's
    cores, and torch's default of one OpenMP thread per core in each, which
    spin at every op's barrier, made small-op tests up to ~50x slower: three
    concurrent runs of ``test_torch_train.py``'s ``Trainer.train`` test took
    370 s each with the default, 7.4 s at one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("x0", [-20.0, -15.5, 15.5, 20.0])
def test_trunc_exp_vjp_matches_jax_beyond_the_clamp(x0):
    rng = np.random.default_rng(0)
    x = (x0 + rng.uniform(-0.4, 0.4, size=64)).astype(np.float32)
    g = rng.normal(size=64).astype(np.float32)
    _, vjp = jax.vjp(j_act.trunc_exp, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    xt = T(x).requires_grad_(True)
    t_act.trunc_exp(xt).backward(T(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-6)
    assert np.all(np.abs(xt.grad.numpy()) <= np.abs(g) * np.exp(15.0) * (1 + 1e-6))


@pytest.mark.parametrize("name", list(HASH_CASES))
def test_hash_encode_vjp_matches_jax(name):
    """The table gradient, with the bf16 rounding of each corner's
    cotangent where the rows are gathered in bf16."""
    case = HASH_CASES[name]
    x, table, res, S, sides = _hash_inputs(case)
    g = np.random.default_rng(9).normal(size=(x.shape[0], 8)).astype(np.float32)
    gd = "bfloat16" if case["gather"] else None
    _, vjp = jax.vjp(lambda t: j_hash.hash_encode(
        jnp.asarray(x), t, res, S, gather_dtype=gd, shared_table=case["shared"],
        dense_sides=sides), jnp.asarray(table))
    (gj,) = vjp(jnp.asarray(g))
    tt = T(table).requires_grad_(True)
    xt = T(x)
    feat = t_hash.hash_encode(xt, tt, res, S,
                              gather_dtype=torch.bfloat16 if gd else None,
                              shared_table=case["shared"], dense_sides=sides)
    feat.backward(T(g))
    assert tt.grad.dtype == torch.float32 and xt.grad is None
    assert rel_l2(tt.grad.numpy(), gj) <= 1e-6


def test_hash_encode_bwd_rounds_corner_cotangents_to_bf16():
    """Without the rounding the bf16-gather gradient differs from JAX's."""
    x, table, res, S, _ = _hash_inputs(HASH_CASES["bf16_hashed"])
    g = np.random.default_rng(10).normal(size=(x.shape[0], 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_hash.hash_encode(jnp.asarray(x), t, res, S,
                                                  gather_dtype="bfloat16"), jnp.asarray(table))
    (gj,) = vjp(jnp.asarray(g))
    rounded = t_hash.hash_encode_bwd_plain(T(x), T(g), table.shape[0], res, S, torch.bfloat16)
    unrounded = t_hash.hash_encode_bwd_plain(T(x), T(g), table.shape[0], res, S)
    assert rel_l2(rounded.numpy(), gj) <= 1e-6 < rel_l2(unrounded.numpy(), gj)


@pytest.mark.parametrize("use_mask", [True, False])
def test_composite_vjp_matches_jax(use_mask):
    sig, rgb, dt, ts, mask = _composite_inputs()
    N, S = sig.shape
    rng = np.random.default_rng(11)
    cts = {"weights_sum": rng.normal(size=N), "depth": rng.normal(size=N),
           "image": rng.normal(size=(N, 3)), "weights": rng.normal(size=(N, S))}
    cts = {k: v.astype(np.float32) for k, v in cts.items()}
    m = mask if use_mask else None

    def fj(s, r):
        return j_comp.composite_rays(s, r, jnp.asarray(dt), jnp.asarray(ts),
                                     mask=None if m is None else jnp.asarray(m))

    _, vjp = jax.vjp(fj, jnp.asarray(sig), jnp.asarray(rgb))
    gs_j, gr_j = vjp({k: jnp.asarray(v) for k, v in cts.items()})
    st, rt = T(sig).requires_grad_(True), T(rgb).requires_grad_(True)
    out = t_comp.composite_rays(st, rt, T(dt), T(ts), mask=None if m is None else T(m))
    torch.autograd.backward([out[k] for k in cts], [T(v) for v in cts.values()])
    assert rel_l2(st.grad.numpy(), gs_j) <= 1e-5
    assert rel_l2(rt.grad.numpy(), gr_j) <= 1e-5
    # terminated rays: no gradient past the stop, none on masked slots
    assert (st.grad.numpy()[:32, -4:] == 0).all()
    if use_mask:
        assert (st.grad.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_field_heads_vjp_matches_jax(dtype):
    jcfg, tcfg = small_cfgs(dtype)
    pj = jax_params(jcfg)
    pt = params_from_jax(pj)
    rng = np.random.default_rng(12)
    M = 1500
    feat = rng.normal(size=(M, tcfg.enc_dim)).astype(np.float32)
    d = rng.normal(size=(M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g_sigma = rng.normal(size=M).astype(np.float32)
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)

    def fj(f, sn, cn):
        p = {"sigma_net": sn, "color_net": cn}
        sigma, geo = j_ngp._sigma_head(p, jcfg, f)
        return sigma, j_ngp.ngp_color(p, jcfg, jnp.asarray(d), geo)

    _, vjp = jax.vjp(fj, jnp.asarray(feat), list(map(jnp.asarray, pj["sigma_net"])),
                     list(map(jnp.asarray, pj["color_net"])))
    gf_j, gs_j, gc_j = vjp((jnp.asarray(g_sigma), jnp.asarray(g_rgb)))
    ft = T(feat).requires_grad_(True)
    nets = pt["sigma_net"] + pt["color_net"]
    for w in nets:
        w.requires_grad_(True)
    sigma, _, rgb = t_ngp.field_heads(pt, tcfg, ft, T(d))
    torch.autograd.backward([sigma, rgb], [T(g_sigma), T(g_rgb)])
    assert rel_l2(ft.grad.numpy(), gf_j) <= 1e-5
    for w, gw in zip(nets, list(gs_j) + list(gc_j)):
        assert rel_l2(w.grad.numpy(), gw) <= 1e-5
