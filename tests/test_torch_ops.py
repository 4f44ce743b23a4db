"""Port parity: the ops of ``nerf_signature_tpu_torch`` against their JAX
counterparts on the same numpy inputs (CPU: the plain PyTorch versions).
The CUDA kernels are held against those plain versions in
test_torch_kernels.py (on the card).

Tolerances and why:
  * exact (``array_equal``): the marcher's mask, the selected candidate
    count and the three counts; near/far; the hash indices.
  * 1e-6 abs: the marcher's ts/deltas/xyzs.  The port computes
    ``t0 + i*dt`` and ``o + t*d`` as separate roundings (so the CUDA kernel
    can match it bit for bit), while XLA on the CPU contracts them into one
    FMA: the two differ by an ulp of t (~2.4e-7 at t ~ 3).
  * rtol 1e-5 / atol 1e-6: fp32 hash features, SH and the compositor
    (reduction order and exp/log ulps differ between XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.ops import activation as j_act
from nerf_signature_tpu.ops import composite as j_comp
from nerf_signature_tpu.ops import hashenc as j_hash
from nerf_signature_tpu.ops import intersect as j_int
from nerf_signature_tpu.ops import marching as j_march
from nerf_signature_tpu.ops import sh as j_sh
from nerf_signature_tpu_torch.ops import activation as t_act
from nerf_signature_tpu_torch.ops import composite as t_comp
from nerf_signature_tpu_torch.ops import hashenc as t_hash
from nerf_signature_tpu_torch.ops import intersect as t_int
from nerf_signature_tpu_torch.ops import marching as t_march

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


def _rays(rng, n, bound):
    """Rays from a ring of origins outside the box, aimed roughly at it."""
    o = rng.normal(size=(n, 3)) * 0.3 * bound + np.array([0.0, 0.0, -2.6 * bound])
    d = rng.normal(size=(n, 3)) * 0.25 + np.array([0.0, 0.0, 1.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# ----------------------------------------------------------------- intersect
def test_near_far_from_aabb_matches_jax_with_miss_sentinel():
    rng = np.random.default_rng(0)
    o, d = _rays(rng, 256, 1.0)
    d[:16] = np.array([1.0, 0.0, 0.0], np.float32)  # parallel to the box: misses
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.2)
    nt, ft = t_int.near_far_from_aabb(T(o), T(d), T(aabb), 0.2)
    assert np.array_equal(_np(nj), nt.numpy()) and np.array_equal(_np(fj), ft.numpy())
    assert (nt.numpy() >= 3.0e38).sum() >= 16


def test_sph_from_ray_matches_jax():
    rng = np.random.default_rng(1)
    o = (rng.normal(size=(64, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    sj = j_int.sph_from_ray(jnp.asarray(o), jnp.asarray(d), 4.0)
    st = t_int.sph_from_ray(T(o), T(d), 4.0)
    np.testing.assert_allclose(st.numpy(), _np(sj), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ sh / exp
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_encode_matches_jax(degree):
    from nerf_signature_tpu_torch.ops.sh import sh_encode

    rng = np.random.default_rng(degree)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(sh_encode(T(d), degree).numpy(),
                               _np(j_sh.sh_encode(jnp.asarray(d), degree)),
                               rtol=1e-5, atol=1e-6)


def test_trunc_exp_forward_and_clamped_backward_match_jax():
    x = np.array([-30.0, -15.5, -1.0, 0.0, 2.0, 15.0, 20.0], np.float32)
    gj = jax.grad(lambda v: jnp.sum(j_act.trunc_exp(v) * 2.0))(jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    yt = t_act.trunc_exp(xt)
    (yt * 2.0).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.exp(x), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), _np(gj), rtol=1e-6)


# ------------------------------------------------------------------- hashenc
def test_hash3_wraps_like_uint32():
    rng = np.random.default_rng(2)
    c = rng.integers(0, 2**20, size=(3, 1000)).astype(np.uint32)
    hj = j_hash._hash3(*(jnp.asarray(v) for v in c), 19)
    ht = t_hash._hash3(*(T(v.astype(np.int64)) for v in c), 19)
    assert np.array_equal(_np(hj).astype(np.int64), ht.numpy())


HASH_CASES = {
    "fp32_hashed": dict(gather=None, dense=False, shared=False),
    "bf16_hashed": dict(gather="bf16", dense=False, shared=False),
    "fp32_dense": dict(gather=None, dense=True, shared=False),
    "bf16_dense": dict(gather="bf16", dense=True, shared=False),
    "bf16_shared": dict(gather="bf16", dense=False, shared=True),
}


def _hash_inputs(case, L=4, S=12, M=512):
    rng = np.random.default_rng(3)
    res = j_hash.level_resolutions(L, 16, 128)
    sides = j_hash.level_sides(res, S, True) if case["dense"] else None
    rows = (int(j_hash.level_row_counts(sides, S).sum()) if sides
            else (1 << S) if case["shared"] else L << S)
    table = rng.uniform(-1, 1, size=(rows, 2)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, size=(M, 3)).astype(np.float32)  # clipped to [0,1]
    return x, table, res, S, sides


@pytest.mark.parametrize("name", list(HASH_CASES))
def test_hash_encode_matches_jax(name):
    case = HASH_CASES[name]
    x, table, res, S, sides = _hash_inputs(case)
    fj = j_hash.hash_encode(jnp.asarray(x), jnp.asarray(table), res, S,
                            gather_dtype="bfloat16" if case["gather"] else None,
                            shared_table=case["shared"], dense_sides=sides)
    ft = t_hash.hash_encode(T(x), T(table), res, S,
                            gather_dtype=torch.bfloat16 if case["gather"] else None,
                            shared_table=case["shared"], dense_sides=sides)
    assert ft.shape == (x.shape[0], 4 * 2) and ft.dtype == torch.float32
    # same gathered rows (bf16 rounding included), fp32 accumulation in the
    # same corner order: only the weight products may differ by an ulp
    np.testing.assert_allclose(ft.numpy(), _np(fj), rtol=1e-5, atol=1e-6)


def test_hash_encode_unported_paths_raise():
    """What JAX's hash_encode refuses the port refuses too (the stochastic
    estimators and the 2D encoder are ported: tests/test_torch_stochastic_hash.py,
    tests/test_torch_background.py)."""
    x, table, res, S, _ = _hash_inputs(HASH_CASES["fp32_hashed"])
    with pytest.raises(ValueError):
        t_hash.hash_encode(T(x), T(table), res, S, shared_table=True, dense_sides=(0,) * 4)
    with pytest.raises(ValueError, match="requires stochastic_grad"):
        t_hash.hash_encode(T(x), T(table), res, S, fwd_corners=1)
    with pytest.raises(ValueError, match="1 or 8"):
        t_hash.hash_encode(T(x), T(table), res, S, stochastic_grad=True, fwd_corners=4)


# ----------------------------------------------------------------- composite
def _composite_inputs(N=128, S=32, seed=4):
    rng = np.random.default_rng(seed)
    sig = rng.exponential(3.0, size=(N, S)).astype(np.float32)
    sig[: N // 4] *= 60.0  # opaque rays: reach T_thresh inside the row
    rgb = rng.uniform(size=(N, S, 3)).astype(np.float32)
    dt = rng.uniform(0.005, 0.05, size=(N, S)).astype(np.float32)
    ts = np.cumsum(dt, axis=-1).astype(np.float32)
    mask = rng.uniform(size=(N, S)) < 0.8
    return sig, rgb, dt, ts, mask


@pytest.mark.parametrize("use_mask", [True, False])
def test_composite_rays_matches_jax(use_mask):
    sig, rgb, dt, ts, mask = _composite_inputs()
    m = mask if use_mask else None
    oj = j_comp.composite_rays(*(jnp.asarray(v) for v in (sig, rgb, dt, ts)),
                               mask=None if m is None else jnp.asarray(m), T_thresh=1e-4)
    ot = t_comp.composite_rays(T(sig), T(rgb), T(dt), T(ts),
                               mask=None if m is None else T(m), T_thresh=1e-4)
    for k in ("weights_sum", "depth", "image", "weights"):
        np.testing.assert_allclose(ot[k].numpy(), _np(oj[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the opaque rays really terminate early
    assert (ot["weights"].numpy()[: 32, -4:] == 0).all()


# ------------------------------------------------------------------ marching
MARCH_CASES = [
    (bound, pf, gamma)
    for bound in (1.0, 2.0)
    for pf in (True, False)
    for gamma in (0.0, 1 / 128)
]


def _march_setup(bound, seed=5, H=32, N=128, frac=0.08):
    rng = np.random.default_rng(seed)
    C = 1 if bound <= 1 else 2
    occ = rng.uniform(size=(C, H, H, H)) < frac
    o, d = _rays(rng, N, bound)
    d[:4] = np.array([0.0, 1.0, 0.0], np.float32)  # misses
    aabb = np.array([-bound] * 3 + [bound] * 3, np.float32)
    return occ, o, d, aabb


def _assert_march_equal(mj, mt):
    for k in ("mask", "n_occupied", "n_occupied_raw", "n_groups_occ", "dirs"):
        assert np.array_equal(_np(mj[k]), mt[k].numpy()), k
    for k in ("ts", "deltas", "xyzs"):
        np.testing.assert_allclose(mt[k].numpy(), _np(mj[k]), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("bound,prefilter,gamma", MARCH_CASES)
def test_march_rays_matches_jax(bound, prefilter, gamma):
    occ, o, d, aabb = _march_setup(bound)
    kw = dict(bound=bound, dt_gamma=gamma, max_steps=128, budget=32,
              grid_size=occ.shape[1], prefilter=prefilter)
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.2)
    mj = j_march.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ), nj, fj, **kw)
    mt = t_march.march_rays_aabb(T(o), T(d), aabb, T(occ), min_near=0.2, bound=bound,
                                 dt_gamma=gamma, max_steps=128, budget=32,
                                 prefilter=prefilter)
    assert np.array_equal(_np(nj), mt["nears"].numpy())
    assert np.array_equal(_np(fj), mt["fars"].numpy())
    _assert_march_equal(mj, mt)
    assert mt["mask"].any() and not mt["mask"].all()


def test_march_auto_prefilter_rule_matches_readme_recipe():
    plan = t_march.march_plan(1, 128, bound=1.0, max_steps=1024, budget=256)
    assert (plan.n_cand, plan.group_budget, plan.prefilter) == (1024, 128, True)
    small = t_march.march_plan(1, 32, bound=1.0, max_steps=128, budget=32)
    assert small.group_budget == 32 and not small.prefilter  # Hc = 16 but 32*4 == n_cand


def test_march_rays_noise_and_tcull_match_jax():
    occ, o, d, aabb = _march_setup(2.0, seed=6)
    rng = np.random.default_rng(7)
    grid = np.where(occ, rng.uniform(0.5, 40.0, size=occ.shape), 0.0).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.uniform(key, (o.shape[0],), dtype=jnp.float32))
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.2)
    kw = dict(bound=2.0, dt_gamma=1 / 128, max_steps=128, budget=32, grid_size=32,
              prefilter=False, t_cull=1e-3)
    mj = j_march.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(grid), nj, fj,
                            perturb_key=key, **kw)
    mt = t_march.march_rays(T(o), T(d), T(grid), T(_np(nj)), T(_np(fj)),
                            noise=T(noise), **kw)
    _assert_march_equal(mj, mt)
    assert (mt["n_occupied"] < mt["n_occupied_raw"]).any()  # the cull bites
    with pytest.raises(ValueError, match="t_cull"):
        t_march.march_rays(T(o), T(d), T(occ), T(_np(nj)), T(_np(fj)), bound=2.0,
                           grid_size=32, t_cull=1e-3)


def test_coarse_dilation_matches_jax():
    rng = np.random.default_rng(8)
    occ = rng.uniform(size=(2, 32, 32, 32)) < 0.01
    cj = j_march.dilate_occupancy(j_march.coarse_occupancy(jnp.asarray(occ), 2), 2)
    ct = t_march.dilate_occupancy(t_march.coarse_occupancy(T(occ), 2), 2)
    assert np.array_equal(_np(cj), ct.numpy())
