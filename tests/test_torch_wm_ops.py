"""Port parity of the watermark stage's modules, op by op, against the JAX
package on the same inputs (CPU: the plain versions of the kernels):
``msg_effective_table`` and its VJP (K9), ``_msg_feature`` for each
``hash_select``, ``wtmk_field``/``wtmk_density``, ``hidden_decoder_apply``,
the distortions with JAX's draws handed over, ``make_loss_w``,
``BitAccMeter.pvalue``, and P1 against the Pallas probe in interpret mode.

Tiny sizes: 4 hash levels of 2^10 rows, finest resolution 64, widths 16,
message_dim 3, message tables at resolution 64 (2^10 rows).  The backbone
table is scaled to U(+-1) and the message tables to U(+-0.1) so the field
and the message feature vary in space.

Tolerances and why:
  * K9 forward: the port adds the selected tables in bit order, XLA's
    reduction may add in another order: rtol 1e-6.  Its VJP is exact (a
    copy into the selected tables, zeros elsewhere).
  * fp32 field and message feature: rtol 1e-5, atol 1e-6 (the same
    arithmetic; matmul sums in another order).  bf16: 2e-2 relative on
    sigma, 1e-2 absolute on rgb (a bf16 step where fp32 sums round
    differently, as in test_torch_field).
  * decoder, fp32: 1e-5 relative (the issue's bound; conv sums in another
    order).  Distortions: atol 1e-5 (grid_sample maps pixel coordinates
    through [-1, 1] and back, an fp32 rounding of the sample position).
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import hidden as j_hidden
from nerf_signature_tpu.models import message as j_msg
from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu.models import watermark as j_wm
from nerf_signature_tpu.train import metrics as j_metrics
from nerf_signature_tpu.train import trainer_wtmk as j_twm
from nerf_signature_tpu.utils import image as j_image
from nerf_signature_tpu_torch.models import hidden as t_hidden
from nerf_signature_tpu_torch.models import message as t_msg
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.models import watermark as t_wm
from nerf_signature_tpu_torch.ops import gather as t_gather
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import metrics as t_metrics
from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
from nerf_signature_tpu_torch.utils import image as t_image

T = torch.from_numpy
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
D_BITS = 3
MESSAGE = np.array([1, 0, 1], np.int32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def wm_cfgs(dtype="fp32", hash_select=1, message_dim=D_BITS):
    """(JAX WatermarkConfig, port WatermarkConfig) at the tiny size."""
    jd, td = DT[dtype]
    kw = dict(bound=1.0, n_levels=4, log2_hashmap_size=10, base_resolution=16,
              finest_resolution=64, hidden_dim=16, hidden_dim_color=16)
    wkw = dict(message_dim=message_dim, msg_resolution=64, msg_log2_hashmap_size=10,
               hash_select=hash_select)
    return (j_wm.WatermarkConfig(ngp=j_ngp.NGPConfig(compute_dtype=jd, **kw), **wkw),
            t_wm.WatermarkConfig(ngp=t_ngp.NGPConfig(compute_dtype=td, **kw), **wkw))


def wm_params(jwcfg, seed=0):
    """JAX init params as numpy: backbone table at U(+-1), msg tables at
    U(+-0.1)."""
    p = jax.tree_util.tree_map(np.asarray,
                               j_wm.init_watermark_params(jax.random.PRNGKey(seed), jwcfg))
    p["backbone"]["hash_table"] = (p["backbone"]["hash_table"] * 1e4).astype(np.float32)
    p["trainable"]["msg_tables"] = (p["trainable"]["msg_tables"] * 1e3).astype(np.float32)
    return p


def port_params(p):
    return (t_ckpt.params_from_jax(p["backbone"]), t_ckpt.trainable_from_jax(p["trainable"]))


def _points(n=512, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_msg_effective_table_and_vjp_match_jax():
    jcfg, _ = wm_cfgs()
    tables = wm_params(jcfg)["trainable"]["msg_tables"]
    g = np.random.default_rng(1).normal(size=tables.shape[2:]).astype(np.float32)
    ej, vjp = jax.vjp(lambda t: j_msg.msg_effective_table(t, jnp.asarray(MESSAGE)),
                      jnp.asarray(tables))
    (gj,) = vjp(jnp.asarray(g))
    tt = T(tables).requires_grad_(True)
    et = t_msg.msg_effective_table(tt, MESSAGE)
    et.backward(T(g))
    np.testing.assert_allclose(et.detach().numpy(), np.asarray(ej), rtol=1e-6, atol=1e-9)
    assert np.array_equal(tt.grad.numpy(), np.asarray(gj))
    # the unselected tables get zeros, the selected ones g_eff
    for i, b in enumerate(MESSAGE):
        assert np.array_equal(tt.grad[i, b].numpy(), g)
        assert not tt.grad[i, 1 - b].any()
    # the gather-dtype copy is the table rounded once (round to nearest even)
    eff, eff_g = t_msg.effective_table(T(tables), MESSAGE, torch.bfloat16)
    assert eff_g.dtype == torch.bfloat16 and torch.equal(eff_g, eff.to(torch.bfloat16))
    # msg_encode: the single-level encode of the effective table
    x01 = np.random.default_rng(3).uniform(size=(256, 3)).astype(np.float32)
    fj = j_msg.msg_encode(jnp.asarray(tables), jnp.asarray(MESSAGE), jnp.asarray(x01),
                          resolution=64, log2_hashmap_size=10)
    ft = t_msg.msg_encode(T(tables), MESSAGE, T(x01), resolution=64, log2_hashmap_size=10)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("hash_select", [0, 1, 2, 3])
def test_msg_feature_and_its_vjp_match_jax(hash_select):
    jcfg, tcfg = wm_cfgs("fp32", hash_select)
    p = wm_params(jcfg)
    _, tr = port_params(p)
    x, _ = _points()
    x01 = (x + 1.0) / 2.0
    trj = jax.tree_util.tree_map(jnp.asarray, p["trainable"])
    fj, vjp = jax.vjp(lambda t: j_wm._msg_feature(dict(trj, msg_tables=t), jcfg,
                                                  jnp.asarray(x01), jnp.asarray(MESSAGE)),
                      trj["msg_tables"])
    g = np.random.default_rng(2).normal(size=np.asarray(fj).shape).astype(np.float32)
    (gj,) = vjp(jnp.asarray(g))
    tr["msg_tables"].requires_grad_(True)
    ft = t_wm._msg_feature(tr, tcfg, T(x01), MESSAGE)
    ft.backward(T(g))
    assert ft.shape == np.asarray(fj).shape
    assert ft.shape[-1] == (8 if hash_select == 0 else 2)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)
    assert rel_l2(tr["msg_tables"].grad.numpy(), np.asarray(gj)) <= 1e-6


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hash_select", [1, 0])
def test_wtmk_field_matches_jax(dtype, hash_select):
    jcfg, tcfg = wm_cfgs(dtype, hash_select)
    p = wm_params(jcfg)
    bb, tr = port_params(p)
    x, d = _points()
    bj = jax.tree_util.tree_map(jnp.asarray, p["backbone"])
    trj = jax.tree_util.tree_map(jnp.asarray, p["trainable"])
    sj, rj = j_wm.wtmk_field(bj, trj, jcfg, jnp.asarray(x), jnp.asarray(d),
                             jnp.asarray(MESSAGE))
    fp = t_wm.wtmk_field_params(bb, tr, tcfg, MESSAGE)
    st, rt = t_wm.wtmk_field(fp, tcfg, T(x), T(d))
    dj = j_wm.wtmk_density(bj, trj, jcfg, jnp.asarray(x), None)["sigma"]
    dt = t_wm.wtmk_density(t_wm.wtmk_field_params(bb, tr, tcfg, None), tcfg, T(x))["sigma"]
    sj, rj, dj = (np.asarray(v, np.float32) for v in (sj, rj, dj))
    if dtype == "fp32":
        for a, b in ((st, sj), (rt, rj), (dt, dj)):
            np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(st.detach().numpy(), sj, rtol=2e-2, atol=0)
        np.testing.assert_allclose(dt.detach().numpy(), dj, rtol=2e-2, atol=0)
        np.testing.assert_allclose(rt.detach().numpy(), rj, rtol=0, atol=1e-2)
    # the message moves the field; without it the field is the backbone's
    assert np.abs(sj - dj).max() > 1e-3 * np.abs(dj).max()
    clean = t_ngp.ngp_density(t_ngp.field_params(bb, tcfg.ngp), tcfg.ngp, T(x))["sigma"]
    assert torch.equal(clean, dt)


def _decoder_inputs(B=6, hw=8, seed=3):
    return np.random.default_rng(seed).normal(size=(B, hw, hw, 3)).astype(np.float32)


def test_hidden_decoder_matches_jax():
    jcfg, tcfg = wm_cfgs()
    p = wm_params(jcfg)["trainable"]
    dec_t = t_ckpt.trainable_from_jax(p)["decoder"]
    x = _decoder_inputs()
    ct = np.random.default_rng(4).normal(size=(x.shape[0], 1)).astype(np.float32)
    dec_j = jax.tree_util.tree_map(jnp.asarray, p["decoder"])
    yj, vjp = jax.vjp(lambda d, xx: j_hidden.hidden_decoder_apply(d, jcfg.decoder, xx), dec_j,
                      jnp.asarray(x))
    gdj, gxj = vjp(jnp.asarray(ct))
    leaves = t_hidden.decoder_leaves(dec_t)
    for leaf in leaves:
        leaf.requires_grad_(True)
    xt = T(x).requires_grad_(True)
    yt = t_hidden.hidden_decoder_apply(dec_t, tcfg.decoder, xt)
    yt.backward(T(ct))
    assert yt.shape == (x.shape[0], 1)
    assert rel_l2(yt.detach().numpy(), np.asarray(yj)) <= 1e-5
    assert rel_l2(xt.grad.numpy(), np.asarray(gxj)) <= 1e-5
    # every parameter's gradient, HWIO on the JAX side
    g_port = t_ckpt.trainable_to_jax({"msg_tables": torch.zeros(1),
                                      "decoder": t_twm._tree_map(lambda t: t.grad, dec_t)})
    pairs = [(a, np.asarray(b)) for a, b in zip(jax.tree_util.tree_leaves(g_port["decoder"]),
                                                jax.tree_util.tree_leaves(gdj))]
    scale = max(np.linalg.norm(b) for _, b in pairs)
    for a, b in pairs:
        if np.linalg.norm(b) > 1e-5 * scale:
            assert rel_l2(a, b) <= 1e-4
        else:  # a conv bias before a batch norm: zero in exact arithmetic
            assert np.linalg.norm(a) <= 1e-5 * scale
    # normalisation constants, both ways
    img = np.random.default_rng(5).uniform(size=(2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(t_hidden.normalize_img(T(img)).numpy(),
                               np.asarray(j_hidden.normalize_img(jnp.asarray(img))), rtol=1e-6)
    np.testing.assert_allclose(t_hidden.unnormalize_img(T(img)).numpy(),
                               np.asarray(j_hidden.unnormalize_img(jnp.asarray(img))),
                               rtol=1e-6)


def jax_draws(kind, key, shape):
    """The random inputs JAX's distortion_layer draws from ``key``."""
    B = shape[0]
    u = functools.partial(jax.random.uniform, key)
    return {"none": None,
            "noise": jax.random.normal(key, shape),
            "rotation": u((B,), minval=-30.0, maxval=30.0),
            "scaling": u((), minval=0.75, maxval=1.25),
            "blurring": u((B,), minval=0.01, maxval=0.5),
            "brightness": u((B, 1, 1, 1), minval=0.5, maxval=1.5),
            "crop": u((), minval=0.3, maxval=0.9)}[kind]


@pytest.mark.parametrize("kind", ["none", "noise", "rotation", "scaling", "blurring",
                                  "brightness", "crop"])
def test_distortions_match_jax(kind):
    rng = np.random.default_rng(6)
    img = rng.uniform(size=(4, 9, 7, 3)).astype(np.float32)
    ct = rng.normal(size=img.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    yj, vjp = jax.vjp(lambda x: j_image.distortion_layer(key, x, kind), jnp.asarray(img))
    (gj,) = vjp(jnp.asarray(ct))
    draws = jax_draws(kind, key, img.shape)
    xt = T(img).requires_grad_(True)
    yt = t_image.distortion_layer(xt, kind, None if draws is None else T(np.asarray(draws)))
    yt.backward(T(ct))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=0, atol=1e-5)
    if kind != "none":  # the draws the port makes itself have the same shapes
        own = t_image.distortion_draws(kind, img.shape, torch.Generator().manual_seed(0), "cpu")
        assert tuple(own.shape) == tuple(np.asarray(draws).shape)


def test_rotation_borders_count_outside_corners_as_zero():
    """A 90-degree turn of a non-square image: the rows that leave the
    canvas are 0, exactly where JAX's map_coordinates puts cval."""
    img = np.ones((1, 6, 10, 3), np.float32)
    yj = np.asarray(j_image.rotate(jnp.asarray(img), jnp.asarray([90.0])))
    yt = t_image.rotate(T(img), torch.tensor([90.0])).numpy()
    np.testing.assert_allclose(yt, yj, atol=1e-5)
    assert (yj == 0).any() and (yj == 1).any()


def test_jpeg_distortion_matches_jax():
    """The jpeg distortion at JAX's draw (a quality index into {40, ..., 90})
    and its straight-through gradient; atol 1e-5 as the other distortions
    (a rounding flip of the quantiser would show here: see test_torch_jpeg,
    which bounds them; these inputs have none)."""
    rng = np.random.default_rng(11)
    img = rng.uniform(size=(2, 12, 12, 3)).astype(np.float32)
    ct = rng.normal(size=img.shape).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        yj, vjp = jax.vjp(lambda x: j_image.distortion_layer(key, x, "jpeg"), jnp.asarray(img))
        (gj,) = vjp(jnp.asarray(ct))
        draws = torch.tensor(int(jax.random.randint(key, (), 0, 6)))
        xt = T(img).requires_grad_(True)
        yt = t_image.distortion_layer(xt, "jpeg", draws)
        yt.backward(T(ct))
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=0, atol=1e-5)
    own = t_image.distortion_draws("jpeg", img.shape, torch.Generator().manual_seed(0), "cpu")
    assert own.dim() == 0 and own.dtype == torch.int64 and 0 <= int(own) < 6


@pytest.mark.parametrize("kind", ["bce", "mse"])
def test_make_loss_w_matches_jax(kind):
    rng = np.random.default_rng(8)
    dec = rng.normal(size=(32,)).astype(np.float32) * 0.3
    bits = rng.integers(0, 2, 32).astype(np.float32)
    lj, gj = jax.value_and_grad(lambda d: j_twm.make_loss_w(kind)(d, jnp.asarray(bits)))(
        jnp.asarray(dec))
    dt = T(dec).requires_grad_(True)
    lt = t_twm.make_loss_w(kind)(dt, T(bits))
    lt.backward()
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-8)


def test_bitacc_meter_and_pvalue_match_jax():
    rng = np.random.default_rng(9)
    mj, mt = j_metrics.BitAccMeter(), t_metrics.BitAccMeter()
    for m in (mj, mt):
        m.clear()
    for _ in range(20):
        bits = rng.integers(0, 2, 32)
        dec = np.where(rng.uniform(size=32) < 0.8, 2.0 * bits - 1.0, 1.0 - 2.0 * bits)
        for m in (mj, mt):
            m.update(dec, bits)
    assert mt.measure() == mj.measure() and mt.records == mj.records
    assert mt.pvalue() == pytest.approx(mj.pvalue(), rel=1e-12)
    assert mt.significance() == mj.significance()
    assert mt.pvalue() < -20


def _load_probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_gather_probe", os.path.join(REPO, "scripts_dev", "pallas_gather_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def test_table_gather_matches_the_pallas_probe_in_interpret_mode(monkeypatch):
    """P1: the port's plain gather against ``pallas_gather`` run by the
    Pallas interpreter at the probe's own shapes."""
    probe = _load_probe()
    pl = probe.pl
    monkeypatch.setattr(probe, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    rng = np.random.default_rng(10)
    table = rng.uniform(size=(probe.TBL,)).astype(np.float32)
    idx = rng.integers(0, probe.TBL, probe.M).astype(np.int32)
    out_j = np.asarray(probe.pallas_gather(jnp.asarray(table)[None], jnp.asarray(idx)[None]))[0]
    out_t = t_gather.table_gather(T(table), T(idx)).numpy()
    assert np.array_equal(out_t, out_j) and np.array_equal(out_t, table[idx])
