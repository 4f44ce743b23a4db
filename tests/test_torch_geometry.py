"""The 8-level table geometries the card takes besides the default 16 x 2:
8 levels x 2 features (K4 at encoding width 16) and 8 x 4 (K1 with 4
features a row, K4 at width 32), held against the JAX package on the CPU
(the plain versions), plus the up-front refusal of what the card lacks.

Sizes: 8 levels of 2^12 rows at resolutions 16, 32, ..., 2048, the default
MLP widths (64), inputs from numpy seeds.  The resolutions are powers of
two, so ``x * res`` is exact: at other resolutions (8 levels from 16 to
128, say) XLA on the CPU contracts ``x * res - floor(x * res)`` into an FMA
and a corner weight moves by an ulp of ``x * res`` (~7.6e-6 below 128), the
known FMA difference of ROADMAP queue 3.  Tolerances and why:
  * hash encoding, fp32 and bf16 gathers: rtol 1e-5 / atol 1e-6 forward
    (the same rows and corner order; weight products may differ by an ulp),
    1e-6 relative L2 for the table's gradient (the same bf16 rounding of
    each corner's cotangent; only the order of the fp32 adds differs), as
    for F = 2 in test_torch_ops / test_torch_train_ops.
  * field heads: fp32 rtol 1e-5 / atol 1e-6; bf16 2e-2 relative (sigma) and
    1e-2 absolute (rgb), a bf16 step where fp32 sums round differently, as
    in test_torch_field.
  * a clean step on the same samples: loss 1e-5 relative; per-leaf
    gradients 1e-5 (fp32) and 1e-3 (bf16) relative L2, as in test_torch_train.
  * the message feature at F = 4: rtol 1e-5 / atol 1e-6, gradient 1e-6, as
    in test_torch_wm_ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu.models import watermark as j_wm
from nerf_signature_tpu.ops import composite as j_comp
from nerf_signature_tpu.ops import hashenc as j_hash
from nerf_signature_tpu.ops import intersect as j_int
from nerf_signature_tpu.ops import marching as j_march
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.models import watermark as t_wm
from nerf_signature_tpu_torch.ops import _cuda
from nerf_signature_tpu_torch.ops import composite as t_comp
from nerf_signature_tpu_torch.ops import hashenc as t_hash
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import trainer as t_trainer
from test_torch_render import H_GRID, ball_occupancy
from test_torch_train import LEAVES, batch, draws, leaves_j, leaves_t
from test_torch_train_ops import rel_l2

T = torch.from_numpy
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
GEOMETRIES = {"8x2": (8, 2), "8x4": (8, 4)}
SMALL = dict(log2_hashmap_size=12, base_resolution=16, finest_resolution=2048)


def cfgs(geometry, dtype, **kw):
    """(JAX NGPConfig, port NGPConfig) of a geometry at the small size."""
    L, F = GEOMETRIES[geometry]
    jd, td = DT[dtype]
    kw = dict(SMALL, bound=1.0, n_levels=L, n_features=F, **kw)
    return j_ngp.NGPConfig(compute_dtype=jd, **kw), t_ngp.NGPConfig(compute_dtype=td, **kw)


def jax_params(jcfg, seed=0):
    """JAX init params as numpy, the table scaled to U(+-1)."""
    p = jax.tree_util.tree_map(np.asarray, j_ngp.init_ngp_params(jax.random.PRNGKey(seed), jcfg))
    p["hash_table"] = (p["hash_table"] * 1e4).astype(np.float32)
    return p


# ------------------------------------------------------------- K1, F = 4
HASH_CASES = {"fp32_hashed": (None, False, False), "bf16_hashed": ("bf16", False, False),
              "bf16_dense": ("bf16", True, False), "bf16_shared": ("bf16", False, True)}


@pytest.mark.parametrize("name", list(HASH_CASES))
def test_hash_encode_four_features_and_vjp_match_jax(name):
    gather, dense, shared = HASH_CASES[name]
    rng = np.random.default_rng(40)
    L, S, F, M = 8, 12, 4, 512
    res = j_hash.level_resolutions(L, 16, 2048)
    sides = j_hash.level_sides(res, S, True) if dense else None
    rows = (int(j_hash.level_row_counts(sides, S).sum()) if sides
            else (1 << S) if shared else L << S)
    table = rng.uniform(-1, 1, size=(rows, F)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, size=(M, 3)).astype(np.float32)
    g = rng.normal(size=(M, L * F)).astype(np.float32)
    g[::3] = 0.0  # padded samples
    gd = "bfloat16" if gather else None
    fj, vjp = jax.vjp(lambda t: j_hash.hash_encode(
        jnp.asarray(x), t, res, S, gather_dtype=gd, shared_table=shared, dense_sides=sides),
        jnp.asarray(table))
    (gj,) = vjp(jnp.asarray(g))
    tt = T(table).requires_grad_(True)
    ft = t_hash.hash_encode(T(x), tt, res, S, gather_dtype=torch.bfloat16 if gd else None,
                            shared_table=shared, dense_sides=sides)
    ft.backward(T(g))
    assert ft.shape == (M, L * F)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)
    assert rel_l2(tt.grad.numpy(), gj) <= 1e-6


# ------------------------------------------------------ K4 at IN = 16 / 32
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_field_heads_match_jax(geometry, dtype):
    jcfg, tcfg = cfgs(geometry, dtype)
    assert t_ngp._kernel_widths(t_ngp.init_ngp_params(torch.Generator(), tcfg), tcfg) == (
        {"8x2": 16, "8x4": 32}[geometry], 64, 16, 64)
    pj = jax_params(jcfg)
    pt = t_ckpt.params_from_jax(pj)
    rng = np.random.default_rng(41)
    x = rng.uniform(-1, 1, size=(1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sj, rj = (np.asarray(v) for v in j_ngp.ngp_field(pj, jcfg, jnp.asarray(x), jnp.asarray(d)))
    st, rt = t_ngp.ngp_field(t_ngp.field_params(pt, tcfg), tcfg, T(x), T(d))
    gj = np.asarray(j_ngp.ngp_density(pj, jcfg, jnp.asarray(x))["geo_feat"])
    gt = t_ngp.ngp_density(pt, tcfg, T(x))["geo_feat"]
    assert np.ptp(sj) > 0.5 and np.ptp(rj) > 0.1  # a field that varies
    if dtype == "fp32":
        for a, b in ((st, sj), (rt, rj), (gt, gj)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(st.numpy(), sj, rtol=2e-2)
        np.testing.assert_allclose(rt.numpy(), rj, atol=1e-2)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=2e-2, atol=1e-2)


# ------------------------------------------------- a clean step, same samples
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_clean_step_loss_and_grads_match_jax(geometry, dtype):
    """The train step's loss (MSE over a random background) and every
    leaf's gradient, on the samples of the JAX march with noise."""
    jcfg, tcfg = cfgs(geometry, dtype)
    pj = jax_params(jcfg, seed=1)
    pt = t_ckpt.params_from_jax(pj)
    occ = ball_occupancy(1.0)
    ro, rd, images = batch(seed=2)
    N = ro.shape[0]
    kperturb, bg, _ = draws(jax.random.PRNGKey(7), N)
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray([-1.0] * 3 + [1.0] * 3), 0.2)
    m = j_march.march_rays(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(occ), nj, fj,
                           bound=1.0, max_steps=128, budget=32, grid_size=H_GRID,
                           perturb_key=kperturb)
    xyz, dirs, deltas, ts, mask = (np.array(m[k]) for k in ("xyzs", "dirs", "deltas", "ts",
                                                               "mask"))
    assert mask.sum() > 100
    gt = images[..., :3] * images[..., 3:] + bg * (1.0 - images[..., 3:])

    def loss_j(p):
        s, r = j_ngp.ngp_field(p, jcfg, jnp.asarray(xyz.reshape(-1, 3)),
                               jnp.asarray(dirs.reshape(-1, 3)))
        o = j_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), jnp.asarray(deltas),
                                  jnp.asarray(ts), mask=jnp.asarray(mask))
        img = o["image"] + (1.0 - o["weights_sum"])[:, None] * bg
        return jnp.mean(jnp.mean((img - gt) ** 2, axis=-1))

    lj, gj = jax.value_and_grad(loss_j)(jax.tree_util.tree_map(jnp.asarray, pj))
    for p in t_trainer.param_leaves(pt):
        p.requires_grad_(True)
    s, r = t_ngp.ngp_field(t_ngp.field_params(pt, tcfg), tcfg, T(xyz.reshape(-1, 3)),
                           T(dirs.reshape(-1, 3)))
    o = t_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), T(deltas), T(ts),
                              mask=T(mask))
    img = o["image"] + (1.0 - o["weights_sum"])[:, None] * T(bg)
    lt = torch.mean(torch.mean((img - T(gt)) ** 2, dim=-1))
    lt.backward()
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    bound = {"fp32": 1e-5, "bf16": 1e-3}[dtype]
    for name, a, b in zip(LEAVES, leaves_j(gj), leaves_t(pt, grad=True)):
        assert rel_l2(b, a) <= bound, (name, rel_l2(b, a))


# --------------------------------------------------- the message feature
@pytest.mark.parametrize("hash_select", [1, 0])
def test_msg_feature_four_features_matches_jax(hash_select):
    jn, tn = cfgs("8x4", "fp32")
    wkw = dict(message_dim=3, msg_resolution=64, msg_log2_hashmap_size=10,
               hash_select=hash_select)
    jcfg, tcfg = j_wm.WatermarkConfig(ngp=jn, **wkw), t_wm.WatermarkConfig(ngp=tn, **wkw)
    p = jax.tree_util.tree_map(np.asarray,
                               j_wm.init_watermark_params(jax.random.PRNGKey(3), jcfg))
    tables = (p["trainable"]["msg_tables"] * 1e3).astype(np.float32)
    assert tables.shape[-1] == 4
    message = np.array([0, 1, 1], np.int32)
    x01 = np.random.default_rng(42).uniform(size=(512, 3)).astype(np.float32)
    trj = jax.tree_util.tree_map(jnp.asarray, dict(p["trainable"], msg_tables=tables))
    fj, vjp = jax.vjp(lambda t: j_wm._msg_feature(dict(trj, msg_tables=t), jcfg,
                                                  jnp.asarray(x01), jnp.asarray(message)),
                      trj["msg_tables"])
    g = np.random.default_rng(43).normal(size=np.asarray(fj).shape).astype(np.float32)
    (gj,) = vjp(jnp.asarray(g))
    tt = T(tables).requires_grad_(True)
    ft = t_wm._msg_feature({"msg_tables": tt}, tcfg, T(x01), message)
    ft.backward(T(g))
    assert ft.shape == np.asarray(fj).shape == (512, 32 if hash_select == 0 else 4)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)
    assert rel_l2(tt.grad.numpy(), gj) <= 1e-6


# ------------------------------------------- what the kernels take, up front
@pytest.mark.parametrize("F", [1, 2, 3, 4, 8])
def test_hash_kernels_take_two_or_four_features(F):
    x = torch.rand((64, 3))
    table = torch.rand((1 << 10, F))
    res = t_hash.level_resolutions(2, 16, 64)
    if F in (2, 4):
        # past the row-width check, the wrapper asks for a CUDA tensor
        with pytest.raises(ValueError, match="CUDA tensor"):
            t_hash._hash_encode_kernel(x, table, 1 << 10, res, 10, True, None)
        with pytest.raises(ValueError, match="CUDA tensor"):
            t_hash._hash_encode_bwd_kernel(x, torch.rand((64, 2 * F)), 1 << 10, res, 10,
                                           torch.float32, True, None)
    else:
        with pytest.raises(ValueError, match="F = "):
            t_hash._hash_encode_kernel(x, table, 1 << 10, res, 10, True, None)
        with pytest.raises(ValueError, match="F = "):
            t_hash._hash_encode_bwd_kernel(x, torch.rand((64, 2 * F)), 1 << 10, res, 10,
                                           torch.float32, True, None)


@pytest.mark.parametrize("levels,features", [(16, 2), (8, 2), (8, 4), (16, 4), (8, 1), (8, 3),
                                             (4, 4), (12, 2), (32, 2)])
def test_kernel_geometry_accepts_exactly_the_built_widths(levels, features):
    cfg = t_ngp.NGPConfig(n_levels=levels, n_features=features, log2_hashmap_size=10)
    params = t_ngp.init_ngp_params(torch.Generator().manual_seed(0), cfg)
    ok = (levels, features) in ((16, 2), (8, 2), (8, 4), (4, 4))  # widths 32, 16, 32, 16
    if ok:
        t_ngp.check_kernel_geometry(cfg)
        assert t_ngp._kernel_widths(params, cfg) in _cuda.FIELD_WIDTHS
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        t_ngp.check_kernel_geometry(cfg)
    if levels * features not in (16, 32):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
            t_ngp._kernel_widths(params, cfg)


def test_cuda_models_refuse_sixteen_by_four_up_front():
    """On a CUDA device string, before anything is built (no card needed)."""
    from nerf_signature_tpu_torch.api import NGPModel, WatermarkModel

    cfg = t_ngp.NGPConfig(n_levels=16, n_features=4, log2_hashmap_size=10)
    for device in ("cuda", None, "cuda:0"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
            NGPModel(cfg, grid_size=16, device=device)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
            WatermarkModel(t_wm.WatermarkConfig(ngp=cfg, message_dim=2,
                                                msg_log2_hashmap_size=10),
                           grid_size=16, device=device)
    # the CPU runs every geometry through the plain versions
    m = NGPModel(cfg, grid_size=16, device="cpu")
    rng = np.random.default_rng(44)
    out = m.render(rng.normal(size=(8, 3)) * 0.1 + [0, 0, -2.0], [[0.0, 0.0, 1.0]] * 8)
    assert out["image"].shape == (8, 3) and bool(torch.isfinite(out["image"]).all())


@pytest.mark.parametrize("cli", ["main_nerf", "main_nerf_wtmk"])
def test_clis_refuse_sixteen_by_four_before_reading_the_scene(tmp_path, cli):
    import importlib

    main = importlib.import_module(f"nerf_signature_tpu_torch.{cli}").main
    argv = [str(tmp_path / "no_scene"), "--workspace", str(tmp_path / "ws"), "-O",
            "--n_levels", "16", "--n_features", "4"]
    if cli == "main_nerf_wtmk":
        argv += ["--wtmk_tcnn", "--ckpt", str(tmp_path / "none.ckpt")]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        main(argv)
    assert not (tmp_path / "ws").exists()
