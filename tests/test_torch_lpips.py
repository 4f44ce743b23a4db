"""Port parity of LPIPS (alex): ``utils/lpips.py`` (the distance, its
gradient, the state-dict loader, the errors), the live ``LPIPSMeter`` and
the patch LPIPS loss of the clean train step, each against the JAX package
on the same inputs (CPU).  The weights are random, in the
``lpips.LPIPS(net='alex')`` layout, written with ``torch.save`` and read by
both packages' loaders (no weights ship with the repo).

Tolerances and why:
  * the distance: 1e-5 relative (measured 2.0e-7): the same fp32
    operations, but XLA's and oneDNN's convolutions sum their 363 to 3456
    products in other orders.
  * its image gradient: 1e-4 relative L2 (measured 3.5e-6): the convs'
    transposes sum in other orders too.
  * the train step on the same samples: loss 1e-5 relative, gradients 1e-5
    relative L2 per leaf, as ``test_torch_train.py`` holds the MSE step
    (the LPIPS term is 1e-3 of the loss).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu.ops import composite as j_comp
from nerf_signature_tpu.ops import intersect as j_int
from nerf_signature_tpu.ops import marching as j_march
from nerf_signature_tpu.train import metrics as j_metrics
from nerf_signature_tpu.utils import lpips as j_lpips
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import composite as t_comp
from nerf_signature_tpu_torch.train import metrics as t_metrics
from nerf_signature_tpu_torch.train import trainer as t_trainer
from nerf_signature_tpu_torch.utils import lpips as t_lpips
from test_torch_render import H_GRID, make_models, view_rays
from test_torch_train import LEAVES, leaves_j, leaves_t
from test_torch_train_ops import one_torch_thread, rel_l2  # noqa: F401

T = torch.from_numpy
BUDGET = 32


def random_state_dict(seed=0):
    """A state dict with lpips-alex's key layout and shapes, random."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i, (o, c, k, _, _) in enumerate(t_lpips._ALEX_CONVS):
        ci = t_lpips._CONV_IDX[i]
        sd[f"net.slice{i + 1}.{ci}.weight"] = torch.from_numpy(
            rng.normal(0, 1.0 / np.sqrt(c * k * k), (o, c, k, k)).astype(np.float32))
        sd[f"net.slice{i + 1}.{ci}.bias"] = torch.from_numpy(
            rng.normal(0, 0.01, (o,)).astype(np.float32))
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(
            np.abs(rng.normal(0, 1.0 / o, (1, o, 1, 1))).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One weights file and both packages' params read from it."""
    path = str(tmp_path_factory.mktemp("lpips") / "alex.pth")
    torch.save(random_state_dict(), path)
    return path, j_lpips.load_lpips_params(path), t_lpips.load_lpips_params(path)


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


def flat(params):
    return [t for c in params["convs"] for t in (c["w"], c["b"])] + list(params["lins"])


def test_loaders_read_the_same_params(weights):
    _, pj, pt = weights
    for a, b in zip(flat(t_lpips.lpips_params_from_jax(pj)), flat(pt)):
        assert torch.equal(a, b)
    assert [tuple(c["w"].shape) for c in pt["convs"]] == [
        (o, c, k, k) for o, c, k, _, _ in t_lpips._ALEX_CONVS]
    # the random init has the same shapes
    init = t_lpips.init_lpips_params(torch.Generator().manual_seed(0))
    assert [c["w"].shape for c in init["convs"]] == [c["w"].shape for c in pt["convs"]]
    assert [v.shape for v in init["lins"]] == [v.shape for v in pt["lins"]]


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 48, 40, 3)])
def test_lpips_distance_and_grad_match_jax(weights, shape):
    _, pj, pt = weights
    a, b = _images(shape, seed=shape[1])
    dj, vjp = jax.vjp(lambda x: j_lpips.lpips_distance(pj, x, jnp.asarray(b)), jnp.asarray(a))
    (gj,) = vjp(jnp.ones_like(dj))
    x = T(a).requires_grad_(True)
    dt = t_lpips.lpips_distance(pt, x, T(b))
    dt.sum().backward()
    assert dt.shape == (shape[0],) and (dt > 0).all()
    np.testing.assert_allclose(dt.detach().numpy(), np.asarray(dj), rtol=1e-5, atol=0)
    assert rel_l2(x.grad.numpy(), np.asarray(gj)) <= 1e-4
    assert float(t_lpips.lpips_distance(pt, T(a), T(a)).abs().max()) <= 1e-7


def test_lpips_errors_match_jax(weights, tmp_path):
    _, pj, pt = weights
    a, b = _images((1, 16, 40, 3), seed=0)
    with pytest.raises(ValueError) as ej:
        j_lpips.lpips_distance(pj, jnp.asarray(a), jnp.asarray(b))
    with pytest.raises(ValueError) as et:
        t_lpips.lpips_distance(pt, T(a), T(b))
    assert str(et.value) == str(ej.value)
    missing = str(tmp_path / "nope.pth")
    with pytest.raises(FileNotFoundError) as ej:
        j_lpips.load_lpips_params(missing)
    with pytest.raises(FileNotFoundError) as et:
        t_lpips.load_lpips_params(missing)
    assert str(et.value) == str(ej.value)


def test_meter_is_na_without_weights_and_jax_s_number_with_them(weights, monkeypatch):
    path, _, _ = weights
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    for meter in (t_metrics.LPIPSMeter(), t_metrics.LPIPSMeter(device="cpu")):
        assert not meter.available
        meter.update(np.zeros((32, 32, 3)), np.ones((32, 32, 3)))
        assert meter.measure() is None and "n/a" in meter.report()
    mj = j_metrics.LPIPSMeter(weights_path=path)
    mt = t_metrics.LPIPSMeter(weights_path=path, device="cpu")
    for seed, shape in ((1, (40, 36, 3)), (2, (2, 32, 32, 3))):
        a, b = _images(shape, seed)
        mj.update(a, b)
        mt.update(a, b)
    assert mt.available and mt.N == mj.N == 2
    assert mt.measure() == pytest.approx(mj.measure(), rel=1e-5)
    assert mt.report().startswith("LPIPSMeter = ")


def _opt(**kw):
    d = dict(lr=1e-2, iters=100, max_ray_batch=128, devices=1, patch_size=32, num_rays=2048,
             max_steps=128, compact_frac=0, group_budget=0, update_extra_interval=16)
    d.update(kw)
    return types.SimpleNamespace(**d)


def test_patch_lpips_step_loss_grads_match_jax_on_the_same_samples(weights):
    """Field, compositor, MSE and ``1e-3 * mean(LPIPS)`` over two 32 x 32
    patches (two views' rows, row-major: the patch layout), differentiated
    on the JAX march's samples; the port's term is the trainer's own
    (``patches`` + ``lpips_distance``)."""
    path, pj, pt = weights
    jm, tm = make_models("fp32", 1.0)
    rays = view_rays(1.0, n=2, res=32, seed=3)
    ro, rd = rays["rays_o"].reshape(-1, 3), rays["rays_d"].reshape(-1, 3)
    N = ro.shape[0]
    gt = np.random.default_rng(3).uniform(size=(N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray([-1.0] * 3 + [1.0] * 3), jm.rc.min_near)
    m = j_march.march_rays(jnp.asarray(ro), jnp.asarray(rd), jm.occ.occupancy, nj, fj,
                           bound=1.0, max_steps=jm.rc.max_steps, budget=BUDGET,
                           grid_size=H_GRID, perturb_key=key)
    xyz, dirs, deltas, ts, mask = (np.asarray(m[k]) for k in ("xyzs", "dirs", "deltas", "ts",
                                                               "mask"))

    def loss_j(p):
        s, r = j_ngp.ngp_field(p, jm.cfg, jnp.asarray(xyz.reshape(-1, 3)),
                               jnp.asarray(dirs.reshape(-1, 3)))
        o = j_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), jnp.asarray(deltas),
                                  jnp.asarray(ts), mask=jnp.asarray(mask))
        img = o["image"] + (1.0 - o["weights_sum"])[:, None]
        loss = jnp.mean(jnp.mean((img - gt) ** 2, axis=-1))
        return loss + 1e-3 * jnp.mean(j_lpips.lpips_distance(
            pj, img.reshape(2, 32, 32, 3), jnp.asarray(gt).reshape(2, 32, 32, 3)))

    lj, gj = jax.value_and_grad(loss_j)(jm.params)
    tt = t_trainer.Trainer("ngp", _opt(lpips_weights=path), tm, workspace=None, mute=True)
    assert tt._lpips_params is not None
    fp = t_ngp.field_params(tm.params, tm.cfg)
    s, r = t_ngp.ngp_field(fp, tm.cfg, T(xyz.reshape(-1, 3)), T(dirs.reshape(-1, 3)))
    o = t_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), T(deltas), T(ts),
                              mask=T(mask))
    img = o["image"] + (1.0 - o["weights_sum"])[:, None]
    lt = torch.mean(torch.mean((img - T(gt)) ** 2, dim=-1))
    lt = lt + 1e-3 * torch.mean(t_lpips.lpips_distance(
        tt._lpips_params, *t_trainer.patches(img, T(gt), 32)))
    lt.backward()
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    for name, a, b in zip(LEAVES, leaves_j(gj), leaves_t(tm.params, grad=True)):
        assert rel_l2(b, a) <= 1e-5, (name, rel_l2(b, a))


def test_trainer_takes_the_patch_lpips_loss_per_step_only(weights, capsys, monkeypatch):
    """With weights and --patch_size 32 the per-step train step runs with the
    term (its loss above the same step's without it); below MIN_SIZE and
    without weights, JAX's skip lines; the device loop refuses the term
    with JAX's message."""
    path, _, _ = weights
    rays = view_rays(1.0, n=2, res=32, seed=4)
    images = np.random.default_rng(4).uniform(size=(2048, 4)).astype(np.float32)
    batch = {"rays_o": rays["rays_o"].reshape(-1, 3), "rays_d": rays["rays_d"].reshape(-1, 3),
             "images": images}
    losses = []
    for kw in (dict(lpips_weights=path), dict(patch_size=1)):
        _, tm = make_models("fp32", 1.0)
        tm.generator.manual_seed(0)
        tt = t_trainer.Trainer("ngp", _opt(**kw), tm, workspace=None, mute=False)
        losses.append(float(tt.train_step_data(batch)[0]))
    assert losses[0] > losses[1] and np.isfinite(losses).all()
    with pytest.raises(RuntimeError, match="not supported with --steps_per_dispatch"):
        tt_l = t_trainer.Trainer("ngp", _opt(lpips_weights=path), tm, workspace=None,
                                 mute=True)
        tt_l.train_device(types.SimpleNamespace())
    out = capsys.readouterr().out
    assert "[lpips] patch LPIPS loss active (1e-3, in-graph)" in out
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    for kw, line in ((dict(lpips_weights=path, patch_size=8), "patch_size 8 < 32"),
                     (dict(), "no weights")):
        tt = t_trainer.Trainer("ngp", _opt(**kw), tm, workspace=None, mute=False)
        assert tt._lpips_params is None
        assert line in capsys.readouterr().out
