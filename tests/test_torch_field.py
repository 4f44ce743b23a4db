"""Port parity for the field: ``mlp_apply``, ``ngp_density`` and
``ngp_field`` of ``nerf_signature_tpu_torch`` against the JAX package on
params built by JAX ``init_ngp_params`` and carried over by
``params_from_jax``.  The fused field kernel (K4) is held against its plain
version in test_torch_kernels.py (on the card).

Tolerances and why:
  * fp32 (``compute_dtype=float32`` on both sides): rtol 1e-5, atol 1e-6 —
    the same arithmetic, in another summation order inside the matmuls.
  * bf16: every layer's output is rounded to bf16 (8 bits of mantissa) in
    both packages, but the fp32 sums before that rounding are taken in
    another order, so now and then one value lands on the neighbouring bf16
    (a relative step of 2**-8 = 0.4%) and carries through later layers:
    2e-2 relative (sigma) and 1e-2 absolute (rgb in [0, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import mlp as j_mlp
from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu_torch.models import mlp as t_mlp
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.train.checkpoint import params_from_jax

T = torch.from_numpy
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def small_cfgs(dtype, bound=1.0):
    jd, td = DT[dtype]
    kw = dict(bound=bound, n_levels=4, log2_hashmap_size=12, base_resolution=16,
              finest_resolution=128, hidden_dim=16, hidden_dim_color=16)
    return j_ngp.NGPConfig(compute_dtype=jd, **kw), t_ngp.NGPConfig(compute_dtype=td, **kw)


def jax_params(jcfg, seed=0, table_scale=1e4):
    """JAX init params as numpy, hash table scaled from U(+-1e-4) to U(+-1) so
    the field varies in space."""
    p = jax.tree_util.tree_map(np.asarray, j_ngp.init_ngp_params(jax.random.PRNGKey(seed), jcfg))
    p["hash_table"] = (p["hash_table"] * table_scale).astype(np.float32)
    return p


def _points(n=1024, bound=1.0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-bound, bound, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_apply_matches_jax(dtype):
    jd, td = DT[dtype]
    rng = np.random.default_rng(1)
    ws = [rng.uniform(-0.5, 0.5, size=s).astype(np.float32) for s in [(8, 16), (16, 16), (16, 3)]]
    x = rng.normal(size=(300, 8)).astype(np.float32)
    yj = np.asarray(j_mlp.mlp_apply([jnp.asarray(w) for w in ws], jnp.asarray(x), compute_dtype=jd))
    yt = t_mlp.mlp_apply([T(w) for w in ws], T(x), compute_dtype=td).numpy()
    assert yt.dtype == np.float32
    if dtype == "fp32":
        np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)
    else:
        # bf16-rounded outputs: identical on most entries, one bf16 step apart
        # on the rest
        assert np.mean(yt == yj) > 0.9
        np.testing.assert_allclose(yt, yj, rtol=2e-2, atol=1e-2)


def test_init_shapes_match_jax():
    jcfg, tcfg = small_cfgs("fp32")
    pj = j_ngp.init_ngp_params(jax.random.PRNGKey(0), jcfg)
    pt = t_ngp.init_ngp_params(torch.Generator().manual_seed(0), tcfg)
    assert pt["hash_table"].shape == pj["hash_table"].shape
    for k in ("sigma_net", "color_net"):
        assert [tuple(w.shape) for w in pt[k]] == [w.shape for w in pj[k]]
    assert float(pt["hash_table"].abs().max()) <= 1e-4
    full = t_ngp.NGPConfig()
    assert full.enc_dim == 32 and full.resolutions[0] == 16.0 and full.resolutions[-1] == 2048.0


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ngp_field_and_density_match_jax(dtype):
    jcfg, tcfg = small_cfgs(dtype)
    pj = jax_params(jcfg)
    pt = params_from_jax(pj)
    x, d = _points()
    sj, rj = j_ngp.ngp_field(pj, jcfg, jnp.asarray(x), jnp.asarray(d))
    st, rt = t_ngp.ngp_field(t_ngp.field_params(pt, tcfg), tcfg, T(x), T(d))
    dj = j_ngp.ngp_density(pj, jcfg, jnp.asarray(x))
    dt = t_ngp.ngp_density(pt, tcfg, T(x))
    sj, rj = np.asarray(sj), np.asarray(rj)
    assert np.ptp(sj) > 0.5 and np.ptp(rj) > 0.1  # a field that varies
    if dtype == "fp32":
        np.testing.assert_allclose(st.numpy(), sj, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rt.numpy(), rj, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(dt["geo_feat"].numpy(), np.asarray(dj["geo_feat"]),
                                   rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(st.numpy(), sj, rtol=2e-2)
        np.testing.assert_allclose(rt.numpy(), rj, atol=1e-2)
        np.testing.assert_allclose(dt["geo_feat"].numpy(), np.asarray(dj["geo_feat"]),
                                   rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(dt["sigma"].numpy(), st.numpy(), rtol=0, atol=0)


def test_ngp_field_plain_flag_is_the_cpu_path():
    jcfg, tcfg = small_cfgs("bf16")
    pt = t_ngp.field_params(params_from_jax(jax_params(jcfg)), tcfg)
    x, d = _points(256)
    a = t_ngp.ngp_field(pt, tcfg, T(x), T(d))
    b = t_ngp.ngp_field(pt, tcfg, T(x), T(d), plain=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
