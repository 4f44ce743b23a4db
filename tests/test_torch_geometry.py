"""The table geometries the card takes besides the default 16 x 2: 8
levels x 2 features (K4 at encoding width 16), 8 x 4 (K1 with 4 features a
row, K4 at width 32), 16 x 4 and 32 x 2 (K4 at width 64), 12 x 2 and 24 x 1
(width 24: K4 at 32, zero-padded; 24 x 1 with rows of 1 feature) and 8 x 8
(rows of 8 features, width 64), held against the JAX package on the CPU
(the plain versions), plus the up-front refusal of what the card lacks.

Sizes: levels of 2^12 rows, the default MLP widths (64), inputs from numpy
seeds; 8 levels at resolutions 16, 32, ..., 2048, 12 levels at 1, 2, ...,
2048, 16 levels at 1, 2, ..., 2^15 (``RESOLUTIONS``), 24 and 32 levels at
1, 1, 2, 2, ..., every octave at two levels (``LEVEL_RESOLUTIONS``; 32
distinct powers of two would reach 2^31).  The resolutions are powers of
two, so ``x * res`` is exact: at other resolutions XLA on the CPU
contracts ``x * res - floor(x * res)`` into an FMA and a corner weight
moves by an ulp of ``x * res``, the known FMA difference of ROADMAP queue 3
(~7.6e-6 below 128, up to 2^-5 of a cell below 2^19).  16 x 4 at 16, 32,
..., 2^19, the finest levels pure hash noise on a 2^12-row table, has a test of
its own (``test_clean_step_to_2_19_matches_jax_given_the_same_bf16_features``):
there the two fp32 encodings, apart on ~6% of the features (within the
forward's tolerance), round a few features to neighbouring bf16 values, and
that alone moves the bf16 gradients by up to 1.06e-2 (``python
tests/test_torch_geometry.py`` prints the readings seed by seed).
Tolerances and why:
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
  * the message feature at F = 1, 4 and 8: rtol 1e-5 / atol 1e-6, gradient
    1e-6, as in test_torch_wm_ops.
"""

import dataclasses

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
from test_torch_train_ops import one_torch_thread, rel_l2  # noqa: F401

T = torch.from_numpy
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
GEOMETRIES = {"8x2": (8, 2), "8x4": (8, 4), "16x4": (16, 4), "32x2": (32, 2), "12x2": (12, 2),
              "24x1": (24, 1), "8x8": (8, 8)}
# (base, finest) resolution by level count: every level's a power of two
RESOLUTIONS = {8: (16, 2048), 12: (1, 2048), 16: (1, 1 << 15)}
# level counts whose resolutions no (base, finest) pair gives as powers of two
LEVEL_RESOLUTIONS = {L: tuple(float(1 << (level // 2)) for level in range(L)) for L in (24, 32)}
# K4's built input width for each geometry's encoding width
BUILT_IN = {"8x2": 16, "8x4": 32, "16x4": 64, "32x2": 64, "12x2": 32, "24x1": 32, "8x8": 64}
SMALL = dict(log2_hashmap_size=12)


def _at_resolutions(cfg, resolutions):
    """cfg with its ``resolutions`` property replaced by a fixed tuple."""
    cls = type(cfg)
    sub = type(cls.__name__, (cls,), {"resolutions": property(lambda self: resolutions)})
    return sub(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def cfgs(geometry, dtype, resolutions=None, **kw):
    """(JAX NGPConfig, port NGPConfig) of a geometry at the small size;
    ``resolutions``: another (base, finest) pair."""
    L, F = GEOMETRIES[geometry]
    jd, td = DT[dtype]
    base, finest = resolutions or RESOLUTIONS.get(L, (16, 16))
    kw = dict(SMALL, base_resolution=base, finest_resolution=finest, bound=1.0, n_levels=L,
              n_features=F, **kw)
    jcfg, tcfg = j_ngp.NGPConfig(compute_dtype=jd, **kw), t_ngp.NGPConfig(compute_dtype=td, **kw)
    if L in LEVEL_RESOLUTIONS and resolutions is None:
        jcfg, tcfg = (_at_resolutions(c, LEVEL_RESOLUTIONS[L]) for c in (jcfg, tcfg))
    return jcfg, tcfg


def jax_params(jcfg, seed=0):
    """JAX init params as numpy, the table scaled to U(+-1)."""
    p = jax.tree_util.tree_map(np.asarray, j_ngp.init_ngp_params(jax.random.PRNGKey(seed), jcfg))
    p["hash_table"] = (p["hash_table"] * 1e4).astype(np.float32)
    return p


# ------------------------------------------------------- K1, F = 1, 4, 8
HASH_CASES = {"fp32_hashed": (None, False, False), "bf16_hashed": ("bf16", False, False),
              "bf16_dense": ("bf16", True, False), "bf16_shared": ("bf16", False, True)}


@pytest.mark.parametrize("name", list(HASH_CASES))
def test_hash_encode_four_features_and_vjp_match_jax(name):
    _hash_encode_and_vjp_match_jax(name, 4)


@pytest.mark.parametrize("name", list(HASH_CASES))
@pytest.mark.parametrize("F", [1, 8])
def test_hash_encode_one_and_eight_features_and_vjp_match_jax(F, name):
    _hash_encode_and_vjp_match_jax(name, F)


def test_hash_encode_takes_a_wider_pitch_only_on_the_kernels():
    """The plain versions (the CPU) refuse a ``pitch`` past L*F, and any
    version one below it (the zero-padded pitch is the kernels',
    tests/test_torch_kernels.py); a pitch of L*F is the unpadded output."""
    rng = np.random.default_rng(45)
    res = t_hash.level_resolutions(12, 16, 2048)
    x = T(rng.uniform(size=(300, 3)).astype(np.float32))
    table = T(rng.uniform(-1, 1, size=(12 << 10, 2)).astype(np.float32))
    for pitch in (32, 23):
        with pytest.raises(ValueError, match="pitch"):
            t_hash.hash_encode(x, table, res, 10, gather_dtype=torch.bfloat16, pitch=pitch)
    tt = table.clone().requires_grad_(True)
    out = t_hash.hash_encode(x, tt, res, 10, gather_dtype=torch.bfloat16, pitch=24)
    g = T(rng.normal(size=(300, 24)).astype(np.float32))
    out.backward(g)
    assert torch.equal(out, t_hash.hash_encode_plain(x, table, res, 10, torch.bfloat16))
    assert torch.equal(tt.grad, t_hash.hash_encode_bwd_plain(
        x, g, 12 << 10, res, 10, torch.bfloat16))


def _hash_encode_and_vjp_match_jax(name, F):
    gather, dense, shared = HASH_CASES[name]
    rng = np.random.default_rng(40)
    L, S, M = 8, 12, 512
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


# ------------------------------------------------- K4 at IN = 16 / 32 / 64
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_field_heads_match_jax(geometry, dtype):
    jcfg, tcfg = cfgs(geometry, dtype)
    assert t_ngp._kernel_widths(t_ngp.init_ngp_params(torch.Generator(), tcfg), tcfg) == (
        BUILT_IN[geometry], 64, 16, 64)
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
def clean_step(jcfg, tcfg, seed=0, same_bf16_features=False):
    """The train step's loss (MSE over a random background) and every leaf's
    gradient in both packages, on the samples of the JAX march with noise:
    (JAX loss, JAX leaves, port loss, port leaves, the two fp32 encodings,
    samples whose features round to other bf16 values in the two packages).  Given
    ``same_bf16_features``, JAX's field heads take the port's fp32 features
    at those samples (values only: the gradients still flow through JAX's
    encoder)."""
    pj = jax_params(jcfg, seed=1 + seed)
    pt = t_ckpt.params_from_jax(pj)
    occ = ball_occupancy(1.0)
    ro, rd, images = batch(seed=2 + seed)
    N = ro.shape[0]
    kperturb, bg, _ = draws(jax.random.PRNGKey(7 + seed), N)
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray([-1.0] * 3 + [1.0] * 3), 0.2)
    m = j_march.march_rays(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(occ), nj, fj,
                           bound=1.0, max_steps=128, budget=32, grid_size=H_GRID,
                           perturb_key=kperturb)
    xyz, dirs, deltas, ts, mask = (np.array(m[k]) for k in ("xyzs", "dirs", "deltas", "ts",
                                                               "mask"))
    assert mask.sum() > 100
    gt = images[..., :3] * images[..., 3:] + bg * (1.0 - images[..., 3:])
    xyz, dirs = xyz.reshape(-1, 3), dirs.reshape(-1, 3)
    feat_j = np.array(j_ngp._encode_pos(pj, jcfg, jnp.asarray(xyz)))
    feat_t = t_ngp._encode_pos(pt, tcfg, T(xyz)).detach().numpy()
    flipped = np.unique(np.nonzero((T(feat_j).bfloat16() != T(feat_t).bfloat16()).numpy())[0])
    swap = np.array(feat_j)
    swap[flipped] = feat_t[flipped]

    def loss_j(p):
        feat = j_ngp._encode_pos(p, jcfg, jnp.asarray(xyz))
        if same_bf16_features:
            feat = feat + jax.lax.stop_gradient(jnp.asarray(swap) - feat)
        s, geo = j_ngp._sigma_head(p, jcfg, feat)
        r = j_ngp.ngp_color(p, jcfg, jnp.asarray(dirs), geo)
        o = j_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), jnp.asarray(deltas),
                                  jnp.asarray(ts), mask=jnp.asarray(mask))
        img = o["image"] + (1.0 - o["weights_sum"])[:, None] * bg
        return jnp.mean(jnp.mean((img - gt) ** 2, axis=-1))

    lj, gj = jax.value_and_grad(loss_j)(jax.tree_util.tree_map(jnp.asarray, pj))
    for p in t_trainer.param_leaves(pt):
        p.requires_grad_(True)
    s, r = t_ngp.ngp_field(t_ngp.field_params(pt, tcfg), tcfg, T(xyz), T(dirs))
    o = t_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), T(deltas), T(ts),
                              mask=T(mask))
    img = o["image"] + (1.0 - o["weights_sum"])[:, None] * T(bg)
    lt = torch.mean(torch.mean((img - T(gt)) ** 2, dim=-1))
    lt.backward()
    return (float(lj), leaves_j(gj), float(lt.detach()), leaves_t(pt, grad=True),
            (feat_j, feat_t), flipped)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_clean_step_loss_and_grads_match_jax(geometry, dtype):
    """The train step's loss (MSE over a random background) and every
    leaf's gradient, on the samples of the JAX march with noise."""
    lj, gj, lt, gt, _, _ = clean_step(*cfgs(geometry, dtype))
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    bound = {"fp32": 1e-5, "bf16": 1e-3}[dtype]
    for name, a, b in zip(LEAVES, gj, gt):
        assert rel_l2(b, a) <= bound, (name, rel_l2(b, a))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clean_step_to_2_19_matches_jax_given_the_same_bf16_features(seed, dtype):
    """16 x 4 at resolutions 16, 32, ..., 2^19.  The two packages' fp32
    encodings agree within the forward's tolerance (rtol 1e-5 / atol 1e-6)
    but not bit for bit: apart on ~6% of the features.  The few of those
    that sit on a bf16 rounding boundary (3 samples at seed 0)
    round to neighbouring bf16 values, and that alone moves the bf16 step's
    gradients by up to 1.06e-2 relative L2 at seed 0 (below 1e-3 at seeds 1
    to 5).  So in bf16 JAX's field heads take the port's fp32 features at
    those samples, and the step then matches under the same-samples limits
    (loss 1e-5 relative; per-leaf 1e-3); in fp32 it matches as it stands
    (1e-5)."""
    jcfg, tcfg = cfgs("16x4", dtype, resolutions=(16, 1 << 19))
    assert jcfg.resolutions[-1] == tcfg.resolutions[-1] == 1 << 19
    lj, gj, lt, gt, (feat_j, feat_t), flipped = clean_step(
        jcfg, tcfg, seed, same_bf16_features=dtype == "bf16")
    np.testing.assert_allclose(feat_t, feat_j, rtol=1e-5, atol=1e-6)
    assert len(flipped) <= 16
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    bound = {"fp32": 1e-5, "bf16": 1e-3}[dtype]
    for name, a, b in zip(LEAVES, gj, gt):
        assert rel_l2(b, a) <= bound, (name, rel_l2(b, a))


# --------------------------------------------------- the message feature
@pytest.mark.parametrize("geometry", ["8x4", "16x4"])
@pytest.mark.parametrize("hash_select", [1, 0])
def test_msg_feature_four_features_matches_jax(hash_select, geometry):
    _msg_feature_matches_jax(hash_select, geometry)


@pytest.mark.parametrize("geometry", ["24x1", "8x8"])
@pytest.mark.parametrize("hash_select", [1, 0])
def test_msg_feature_one_and_eight_features_matches_jax(hash_select, geometry):
    """K9's tables and the message's K1 at rows of 1 and 8 features."""
    _msg_feature_matches_jax(hash_select, geometry)


def _msg_feature_matches_jax(hash_select, geometry):
    L, F = GEOMETRIES[geometry]
    jn, tn = cfgs(geometry, "fp32")
    wkw = dict(message_dim=3, msg_resolution=64, msg_log2_hashmap_size=10,
               hash_select=hash_select)
    jcfg, tcfg = j_wm.WatermarkConfig(ngp=jn, **wkw), t_wm.WatermarkConfig(ngp=tn, **wkw)
    p = jax.tree_util.tree_map(np.asarray,
                               j_wm.init_watermark_params(jax.random.PRNGKey(3), jcfg))
    tables = (p["trainable"]["msg_tables"] * 1e3).astype(np.float32)
    assert tables.shape[-1] == F
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
    assert ft.shape == np.asarray(fj).shape == (512, F * L if hash_select == 0 else F)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)
    assert rel_l2(tt.grad.numpy(), gj) <= 1e-6


# ------------------------------------------- what the kernels take, up front
@pytest.mark.parametrize("F", [1, 2, 3, 4, 8])
def test_hash_kernels_take_one_two_four_or_eight_features(F):
    x = torch.rand((64, 3))
    table = torch.rand((1 << 10, F))
    res = t_hash.level_resolutions(2, 16, 64)
    if F in (1, 2, 4, 8):
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
                                             (4, 4), (12, 2), (32, 2), (8, 8), (24, 1), (16, 8),
                                             (40, 1)])
def test_kernel_geometry_accepts_exactly_the_built_widths(levels, features):
    """F in {1, 2, 4, 8}, at most 32 levels and an encoding width up to 64,
    run at the smallest built K4 input width at least as wide (8 x 1 at 16,
    12 x 2 at 32, 8 x 8 at 64); F = 3, 16 x 8 (width 128) and 40 levels are
    refused."""
    cfg = t_ngp.NGPConfig(n_levels=levels, n_features=features, log2_hashmap_size=10)
    params = t_ngp.init_ngp_params(torch.Generator().manual_seed(0), cfg)
    width = levels * features
    ok = features in (1, 2, 4, 8) and levels <= 32 and width <= 64
    if ok:
        t_ngp.check_kernel_geometry(cfg)
        built = t_ngp._kernel_widths(params, cfg)
        assert built in _cuda.FIELD_WIDTHS
        assert built[0] == min(w for w in (16, 32, 64) if w >= width)
        assert t_ngp.feature_pitch(cfg) == built[0]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        t_ngp.check_kernel_geometry(cfg)
    if width > 64:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
            t_ngp._kernel_widths(params, cfg)


def test_cuda_models_refuse_sixteen_by_eight_up_front():
    """On a CUDA device string, before anything is built (no card needed):
    16 x 8, encoding width 128, above K4's widest build."""
    from nerf_signature_tpu_torch.api import NGPModel, WatermarkModel

    cfg = t_ngp.NGPConfig(n_levels=16, n_features=8, log2_hashmap_size=10)
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
def test_clis_refuse_sixteen_by_eight_before_reading_the_scene(tmp_path, cli):
    import importlib

    main = importlib.import_module(f"nerf_signature_tpu_torch.{cli}").main
    argv = [str(tmp_path / "no_scene"), "--workspace", str(tmp_path / "ws"), "-O",
            "--n_levels", "16", "--n_features", "8"]
    if cli == "main_nerf_wtmk":
        argv += ["--wtmk_tcnn", "--ckpt", str(tmp_path / "none.ckpt")]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        main(argv)
    assert not (tmp_path / "ws").exists()


def _permuted(mlp_apply, seed):
    """``mlp_apply`` with the MLP's inputs and hidden units in another order
    (the same function, other sum orders)."""
    def run(params, x, **kw):
        rng = np.random.default_rng(seed)
        perms = [rng.permutation(params[0].shape[0])] + [
            rng.permutation(w.shape[1]) for w in params[:-1]]
        ws = [w[perms[i]] if i == len(params) - 1 else w[perms[i]][:, perms[i + 1]]
              for i, w in enumerate(params)]
        return mlp_apply(ws, x[:, perms[0]], **kw)
    return run


if __name__ == "__main__":
    # The bf16 gap at 16 x 4 up to resolution 2^19, seed by seed: the port
    # against JAX as they stand, how many fp32 features are apart and how
    # many round to other bf16 values, JAX with the port's features at
    # those samples, and each package against itself with its MLPs' sum
    # orders permuted.  JAX_PLATFORMS=cpu python tests/test_torch_geometry.py
    import sys

    def worst(a, b):
        return max((rel_l2(x, y), n) for n, x, y in zip(LEAVES, a, b))

    for seed in range(int(sys.argv[1]) if len(sys.argv) > 1 else 6):
        jcfg, tcfg = cfgs("16x4", "bf16", resolutions=(16, 1 << 19))
        _, gj, _, gt, (fj, ft), flipped = clean_step(jcfg, tcfg, seed)
        _, gs, _, _, _, _ = clean_step(jcfg, tcfg, seed, same_bf16_features=True)
        mj, mt = j_ngp.mlp_apply, t_ngp.mlp_apply
        j_ngp.mlp_apply, t_ngp.mlp_apply = _permuted(mj, 100 + seed), _permuted(mt, 100 + seed)
        _, gjp, _, gtp, _, _ = clean_step(jcfg, tcfg, seed)
        j_ngp.mlp_apply, t_ngp.mlp_apply = mj, mt
        print(f"seed {seed}: port vs JAX {worst(gt, gj)}; fp32 features apart "
              f"{int((fj != ft).sum())} of {fj.size}, bf16 roundings apart at {len(flipped)} "
              f"samples; port vs JAX given those {worst(gt, gs)}, JAX vs itself given them "
              f"{worst(gs, gj)}; permuted MLPs: JAX {worst(gjp, gj)}, port {worst(gtp, gt)}",
              flush=True)
