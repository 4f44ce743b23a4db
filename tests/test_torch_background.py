"""Port parity of K8 and the background-sphere model (``--bg_radius > 0``)
against the JAX package on the same numpy inputs (CPU: the plain versions;
the kernels are held against these on the card in test_torch_kernels.py):
``sph_from_ray``, ``hash_encode_2d`` forward and backward, ``bg_encode``
on rays, ``ngp_background``, renders whose misses take the bg colour, the
clean step's loss and the gradients of every leaf (``bg_table`` and
``bg_net`` included), the watermark stage's renders on the frozen
backbone's bg, both device loops, the checkpoints both ways and both CLIs.

Tolerances and why:
  * ``sph_from_ray``: atol 1e-6 (atan2 and sqrt ulps), except the rays
    whose exit point lies within 1e-6 of phi's branch cut
    (``hashenc.sphere_cut``): there phi = +-1 may come out either way in
    either package, so they are counted (``CUT``, with rays aimed at the
    cut on purpose) and left out of every comparison.
  * ``hash_encode_2d`` on the same positions: rtol 1e-5 / atol 1e-6 (the
    weight products, like K1); its table gradient the same (the scatter's
    sum order); ``bg_encode`` on rays atol 1e-4 (an ulp of the sphere point
    times a resolution of 64 moves a weight by ~4e-6, times rows of U(+-1)).
  * the bg colour and renders: atol 1e-5 (fp32); steps and loops: the
    bounds of tests/test_torch_train.py and tests/test_torch_device_loop.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.api import NGPModel as JModel
from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu.ops import composite as j_comp
from nerf_signature_tpu.ops import hashenc as j_hash
from nerf_signature_tpu.ops import intersect as j_int
from nerf_signature_tpu.ops import marching as j_march
from nerf_signature_tpu_torch.api import NGPModel as TModel
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import composite as t_comp
from nerf_signature_tpu_torch.ops import hashenc as t_hash
from nerf_signature_tpu_torch.ops import intersect as t_int
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import trainer as t_trainer
from test_torch_field import jax_params, small_cfgs
from test_torch_render import H_GRID, ball_occupancy, view_rays
from test_torch_train_ops import rel_l2

T = torch.from_numpy
RADIUS = 8.0  # the JAX tests' radius; the cameras orbit at 2.2-3.2
BG = dict(bg_radius=RADIUS, bg_n_levels=2, bg_log2_hashmap_size=10, bg_finest_resolution=64)
BG_RES = j_hash.level_resolutions(2, 16, 64)  # 16, 64
N_RAYS = 400
CUT = 3  # rays at phi's branch cut among _rays' (the three aimed at it)
BUDGET = 32


def _rays(n=N_RAYS, seed=0):
    """Rays from inside the sphere, three of them aimed so that their exit
    point lies on phi's branch cut (y = 0, x < 0)."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    o[:3] = [[0.0, 0.0, 0.0], [0.5, 0.0, -1.0], [-2.0, 0.0, 1.0]]
    d[:3] = [[-1.0, 0.0, 0.3], [-1.0, 0.0, 0.0], [-0.5, 0.0, -2.0]]
    return o, d


def bg_models(dtype="fp32", budget=BUDGET):
    """(JAX model, port model) with the bg-sphere model at the tiny size,
    the same params (both hash tables at U(+-1)), the ball's grid."""
    jcfg, tcfg = small_cfgs(dtype, 1.0)
    jcfg, tcfg = dataclasses.replace(jcfg, **BG), dataclasses.replace(tcfg, **BG)
    kw = dict(density_thresh=0.01, max_steps=128, grid_size=H_GRID, infer_budget=budget)
    jm = JModel(jcfg, **kw)
    tm = TModel(tcfg, device="cpu", **kw)
    pj = jax_params(jcfg)
    pj["bg_table"] = (pj["bg_table"] * 1e4).astype(np.float32)
    jm.params = jax.tree_util.tree_map(jnp.asarray, pj)
    tm.params = t_ckpt.params_from_jax(pj)
    occ = ball_occupancy(1.0)
    jm.occ = jm.occ._replace(occupancy=jnp.asarray(occ))
    tm.occ = tm.occ._replace(occupancy=T(occ))
    return jm, tm


def leaves_j(tree):
    """JAX params in the port's optimizer order (``param_leaves``)."""
    return ([np.asarray(tree["hash_table"])] + [np.asarray(w) for w in tree["sigma_net"]]
            + [np.asarray(w) for w in tree["color_net"]] + [np.asarray(tree["bg_table"])]
            + [np.asarray(w) for w in tree["bg_net"]])


def leaves_t(params, grad=False):
    return [(p.grad if grad else p).detach().numpy() for p in t_trainer.param_leaves(params)]


# --------------------------------------------------------------- the ops
def test_sph_from_ray_matches_jax_off_the_cut():
    o, d = _rays()
    cut = t_hash.sphere_cut(T(o), T(d), RADIUS).numpy()
    assert int(cut.sum()) == CUT and cut[:3].all()
    sj = np.asarray(j_int.sph_from_ray(jnp.asarray(o), jnp.asarray(d), RADIUS))
    st = t_int.sph_from_ray(T(o), T(d), RADIUS).numpy()
    np.testing.assert_allclose(st[~cut], sj[~cut], rtol=0, atol=1e-6)
    # at the cut phi is +-1 in both
    assert np.allclose(np.abs(st[cut, 1]), 1.0) and np.allclose(np.abs(sj[cut, 1]), 1.0)


@pytest.mark.parametrize("F", [2, 4])
@pytest.mark.parametrize("gather", ["fp32", "bf16"])
def test_hash_encode_2d_matches_jax(gather, F):
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, size=(2 << 10, F)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, size=(N_RAYS, 2)).astype(np.float32)
    w = rng.normal(size=(N_RAYS, 2 * F)).astype(np.float32)
    gd_t, gd_j = (torch.bfloat16, "bfloat16") if gather == "bf16" else (None, None)

    def fj(t):
        return j_hash.hash_encode_2d(jnp.asarray(x), t, BG_RES, 10, gather_dtype=gd_j)

    oj = np.asarray(fj(jnp.asarray(table)))
    gj = np.asarray(jax.grad(lambda t: jnp.sum(fj(t) * w))(jnp.asarray(table)))
    tt = T(table.copy()).requires_grad_(True)
    ot = t_hash.hash_encode_2d(T(x), tt, BG_RES, 10, gather_dtype=gd_t)
    (ot * T(w)).sum().backward()
    assert ot.shape == (N_RAYS, 2 * F)
    np.testing.assert_allclose(ot.detach().numpy(), oj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), gj, rtol=1e-5, atol=1e-6)
    if gather == "bf16":  # the cotangent rounded to bf16 before the fp32 scatter, as K1's
        plain = t_hash.hash_encode_2d_bwd_plain(T(x), T(w), table.shape[0], BG_RES, 10)
        assert not torch.equal(plain, tt.grad)


def test_bg_encode_on_rays_matches_jax():
    o, d = _rays(seed=2)
    cut = t_hash.sphere_cut(T(o), T(d), RADIUS).numpy()
    table = np.random.default_rng(2).uniform(-1, 1, size=(2 << 10, 2)).astype(np.float32)
    sph = j_int.sph_from_ray(jnp.asarray(o), jnp.asarray(d), RADIUS)
    fj = np.asarray(j_hash.hash_encode_2d((sph + 1.0) * 0.5, jnp.asarray(table), BG_RES, 10))
    ft = t_hash.bg_encode(T(o), T(d), RADIUS, T(table), BG_RES, 10).numpy()
    assert int(cut.sum()) == CUT
    np.testing.assert_allclose(ft[~cut], fj[~cut], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ngp_background_matches_jax(dtype):
    """The bg colour: atol 1e-5 in fp32; in bf16 (JAX eager: a jitted
    program keeps excess bf16 precision) within a bf16 step of the MLP's
    output through the sigmoid, atol 4e-3."""
    jm, tm = bg_models(dtype)
    o, d = _rays(seed=3)
    cut = t_hash.sphere_cut(T(o), T(d), RADIUS).numpy()
    bg = lambda p, a, b: j_ngp.ngp_background(p, jm.cfg, a, b)
    cj = np.asarray((jax.jit(bg) if dtype == "fp32" else bg)(
        jm.params, jnp.asarray(o), jnp.asarray(d)))
    ct = t_ngp.ngp_background(tm.params, tm.cfg, T(o), T(d)).numpy()
    assert ct.shape == (N_RAYS, 3) and ((ct > 0) & (ct < 1)).all()
    np.testing.assert_allclose(ct[~cut], cj[~cut], rtol=0,
                               atol={"fp32": 1e-5, "bf16": 4e-3}[dtype])
    assert np.ptp(ct[~cut], axis=0).min() > 0.05  # the colour varies with the direction


def test_render_misses_take_the_bg_colour():
    """An empty grid: every ray's image is the bg model's colour, not white,
    in both packages (JAX's test_background.py:65)."""
    jm, tm = bg_models()
    for m in (jm, tm):
        m.occ = m.occ._replace(occupancy=m.occ.occupancy & False)
    rays = view_rays(1.0, n=1, res=12, seed=4)
    ro, rd = rays["rays_o"][0], rays["rays_d"][0]
    it = tm.render(ro, rd)["image"].numpy()
    ij = np.asarray(jm.render(jnp.asarray(ro), jnp.asarray(rd))["image"])
    expect = t_ngp.ngp_background(tm.params, tm.cfg, T(ro), T(rd)).numpy()
    np.testing.assert_allclose(it, expect, rtol=0, atol=1e-6)
    np.testing.assert_allclose(it, ij, rtol=0, atol=1e-5)
    assert not np.allclose(it, 1.0)
    # with the ball in the grid, the staged render agrees with JAX's too
    jm, tm = bg_models()
    it = tm.render(ro, rd, staged=True, max_ray_batch=64)["image"].numpy()
    ij = np.asarray(jm.render(jnp.asarray(ro), jnp.asarray(rd), staged=True,
                              max_ray_batch=64)["image"])
    np.testing.assert_allclose(it, ij, rtol=0, atol=1e-4)


# --------------------------------------------------------- the clean step
def _batch(seed=0, res=16):
    rays = view_rays(1.0, n=1, res=res, seed=seed)
    ro, rd = rays["rays_o"][0], rays["rays_d"][0]
    images = np.random.default_rng(seed).uniform(size=(ro.shape[0], 4)).astype(np.float32)
    return ro, rd, images


def test_clean_step_grads_match_jax_on_the_same_samples():
    """Field, compositor, the bg model and the loss (GT over white, the bg
    model's colour in the render) differentiated on JAX's march, in fp32:
    the loss and every leaf's gradient, bg_table and bg_net included (1e-5,
    as the field's own)."""
    jm, tm = bg_models()
    ro, rd, images = _batch()
    N = ro.shape[0]
    kperturb = jax.random.split(jax.random.PRNGKey(3))[1]
    nj, fj = j_int.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray([-1.0] * 3 + [1.0] * 3), jm.rc.min_near)
    m = j_march.march_rays(jnp.asarray(ro), jnp.asarray(rd), jm.occ.occupancy, nj, fj,
                           bound=1.0, max_steps=jm.rc.max_steps, budget=BUDGET,
                           grid_size=H_GRID, perturb_key=kperturb)
    xyz, dirs, deltas, ts, mask = (np.asarray(m[k]) for k in ("xyzs", "dirs", "deltas", "ts",
                                                               "mask"))
    gt = images[..., :3] * images[..., 3:] + (1.0 - images[..., 3:])

    def loss_j(p):
        s, r = j_ngp.ngp_field(p, jm.cfg, jnp.asarray(xyz.reshape(-1, 3)),
                               jnp.asarray(dirs.reshape(-1, 3)))
        o = j_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), jnp.asarray(deltas),
                                  jnp.asarray(ts), mask=jnp.asarray(mask))
        bg = j_ngp.ngp_background(p, jm.cfg, jnp.asarray(ro), jnp.asarray(rd))
        img = o["image"] + (1.0 - o["weights_sum"])[:, None] * bg
        return jnp.mean(jnp.mean((img - gt) ** 2, axis=-1))

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(jm.params)
    for p in t_trainer.param_leaves(tm.params):
        p.requires_grad_(True)
    fp = t_ngp.field_params(tm.params, tm.cfg)
    s, r = t_ngp.ngp_field(fp, tm.cfg, T(xyz.reshape(-1, 3)), T(dirs.reshape(-1, 3)))
    o = t_comp.composite_rays(s.reshape(N, -1), r.reshape(N, -1, 3), T(deltas), T(ts),
                              mask=T(mask))
    bg = t_ngp.background_fn(fp, tm.cfg)(T(ro), T(rd))
    img = o["image"] + (1.0 - o["weights_sum"])[:, None] * bg
    lt = torch.mean(torch.mean((img - T(gt)) ** 2, dim=-1))
    lt.backward()
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    bound = 1e-5
    gt_ = leaves_t(tm.params, grad=True)
    assert len(gt_) == 9 and np.abs(gt_[6]).sum() > 0 and np.abs(gt_[7]).sum() > 0
    for i, (a, b) in enumerate(zip(leaves_j(gj), gt_)):
        assert rel_l2(b, a) <= bound, (i, rel_l2(b, a))


def test_train_step_with_bg_matches_jax_train_step():
    """Trainer._train_step against JAX's _train_step on RGBA pixels: the
    bg model's colour in the render, the ground truth over white, no
    random background drawn (the port's draws give white); each package
    marches (FMA ulps, tests/test_torch_train.py's bounds: loss 1e-5,
    leaves 1e-3 / 1e-4)."""
    import types

    from nerf_signature_tpu.train import trainer as j_trainer

    jm, tm = bg_models()
    opt = types.SimpleNamespace(lr=1e-2, iters=100, max_ray_batch=128, devices=1, patch_size=1,
                                num_rays=256, max_steps=128, compact_frac=-1, group_budget=-1,
                                update_extra_interval=16)
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    ro, rd, images = _batch(seed=1)
    key = jax.random.PRNGKey(11)
    bg, _ = tt.draws(ro.shape[0], True)
    assert torch.equal(bg, torch.ones((1, 3)))
    noise = np.asarray(jax.random.uniform(jax.random.split(key)[1], (ro.shape[0],)))
    out_j = j_trainer._train_step(
        jm.params, jt.ema_params, jt.opt_state, jm.occ.occupancy, jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(images), key, jm.cfg, jm.rc, BUDGET, jt.optimizer.update,
        True, jt.ema_decay)
    p0 = [a.copy() for a in leaves_t(tm.params)]
    lt, prt, *_ = tt._train_step(T(ro), T(rd), T(images), bg, T(noise), tm.rc, BUDGET)
    assert abs(float(lt) - float(out_j[3])) <= 1e-5 * abs(float(out_j[3]))
    np.testing.assert_allclose(prt.numpy(), np.asarray(out_j[4]), rtol=1e-4, atol=1e-7)
    # one Adam step (eps 1e-15) moves every leaf with a gradient by ~lr: the
    # bg leaves moved, and where both packages' gradients are sure of their
    # sign the params agree
    for i, (a, b, w0) in enumerate(zip(leaves_j(out_j[0]), leaves_t(tm.params), p0)):
        moved = np.abs(b - w0) > 0
        assert moved.mean() > 0.05, i
        assert rel_l2(b - w0, a - w0) <= 0.2, (i, rel_l2(b - w0, a - w0))


# ------------------------------------------------- the watermark stage
def test_wm_renders_take_the_frozen_backbone_bg():
    """The watermark stage's key-block render composites misses onto the
    frozen backbone's bg model (JAX's test_wm_block_render_uses_backbone_bg),
    and the whole step's render too, in both packages."""
    from nerf_signature_tpu.train import trainer_wtmk as j_twm
    from nerf_signature_tpu_torch.models import watermark as t_wm
    from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
    from test_torch_wm_ops import port_params, wm_cfgs, wm_params

    jw, tw = wm_cfgs()
    jw = dataclasses.replace(jw, ngp=dataclasses.replace(jw.ngp, **BG))
    tw = dataclasses.replace(tw, ngp=dataclasses.replace(tw.ngp, **BG))
    p = wm_params(jw)
    p["backbone"]["bg_table"] = (p["backbone"]["bg_table"] * 1e4).astype(np.float32)
    backbone, trainable = port_params(p)
    from nerf_signature_tpu.ops.grid import init_occupancy_grid
    from nerf_signature_tpu.render.renderer import RenderConfig as JRC
    from nerf_signature_tpu_torch.render.renderer import RenderConfig as TRC

    occ = np.zeros(np.asarray(init_occupancy_grid(1.0, 8).occupancy).shape, bool)
    D, bh, bw = 2, 4, 4
    ro = np.full((D, bh, bw, 3), -2.0, np.float32)
    rd = np.tile(np.array([1.0, 0.3, 0.2], np.float32), (D, bh, bw, 1))
    msg = np.array([0, 1, 1], np.int32)
    blocks = jax.jit(lambda bb, tr, g, o, d, m: j_twm._render_blocks(
        bb, tr, g, o, d, m, jw, JRC(bound=1.0, grid_size=8, max_steps=32), budget=8))
    bj = np.asarray(blocks(jax.tree_util.tree_map(jnp.asarray, p["backbone"]),
                           jax.tree_util.tree_map(jnp.asarray, p["trainable"]),
                           jnp.asarray(occ), jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(msg)))
    fp = t_wm.wtmk_field_params(backbone, trainable, tw, T(msg))
    bt = t_twm._render_blocks(fp, T(occ), T(ro), T(rd), tw, TRC(bound=1.0, grid_size=8,
                                                                  max_steps=32), 8)
    expect = t_ngp.ngp_background(backbone, tw.ngp, T(ro.reshape(-1, 3)), T(rd.reshape(-1, 3)))
    np.testing.assert_allclose(bt.numpy().reshape(-1, 3), expect.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-5)
    assert not np.allclose(bt.numpy(), 1.0)


# ---------------------------------------------------- the device loops
def test_clean_loop_with_bg_matches_jax():
    """``device_train_loop`` with --bg_radius 8 against JAX's loop on
    JAX's draws (no background drawn; the ground truth over white): the
    exact loop's bounds (tests/test_torch_device_loop.py): losses 1e-5,
    params 1e-4, EMA 1e-5, every leaf, bg_table and bg_net included."""
    from nerf_signature_tpu.train import device_loop as j_dl
    from nerf_signature_tpu.train import trainer as j_trainer
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from test_torch_device_loop import (DENSITY_THRESH, H, N_RAYS, P, W, _clean_opt, _views,
                                        jax_clean_draws)

    n_steps = 8
    jm, tm = bg_models()
    for m in (jm, tm):
        m.rc = dataclasses.replace(m.rc, compact_frac=0.5)
        m.train_budget = BUDGET
        m.density_thresh = DENSITY_THRESH
    opt = _clean_opt()
    jt = j_trainer.Trainer("ngp", opt, jm, workspace=None, use_checkpoint="scratch", mute=True)
    tt = t_trainer.Trainer("ngp", opt, tm, workspace=None, use_checkpoint="scratch", mute=True)
    poses, images, intr = _views(4)
    key = jax.random.PRNGKey(7)
    out = j_dl.device_train_loop(
        jm.params, jt.ema_params, jt.opt_state, jm.occ, jnp.asarray(poses),
        jnp.asarray(images.reshape(P, -1, 4)), jnp.asarray(intr), key, 0, jt.cfg_train,
        jt._rc_train(), BUDGET, jt.optimizer.update, True, jt.ema_decay, n_steps, N_RAYS, H, W,
        update_interval=16, density_thresh=jm.density_thresh, grid_full_until=16)
    draws, grid = jax_clean_draws(key, n_steps, tm.occ.density.shape[0], {0: True})
    draws = draws._replace(bg=None)  # JAX draws none with the bg model
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    stats = t_dl.device_train_loop(tt, data, n_steps, draws=draws,
                                   grid_draws=lambda step, full: grid[step])
    np.testing.assert_allclose(stats.losses, np.asarray(out[4]), rtol=1e-5)
    for i, (pj, pt) in enumerate(zip(leaves_j(out[0]), leaves_t(tm.params))):
        assert rel_l2(pt, pj) <= 1e-4, i
    for ej, et in zip(leaves_j(out[1]), leaves_t(tt.ema_params)):
        assert rel_l2(et, ej) <= 1e-5


def test_wm_loop_on_a_bg_backbone_matches_jax():
    """``wm_device_loop`` on a backbone with the bg model (its colour in
    every render) against JAX's loop, 3 steps.  Step 0 agrees to 1e-5;
    after Adam's first step the bg colour's ulps (atan2, the rays) go the
    way of the exact loop's ulps (tests/test_torch_device_loop.py: the
    decoder's batch norms and the BCE carry Adam's sign flips), measured
    6.4e-5 relative at step 1: losses 1e-5 at step 0, 1e-3 after; message
    tables 1e-2, as the exact loop's."""
    from nerf_signature_tpu import api as j_api
    from nerf_signature_tpu.train import trainer_wtmk as j_twm
    from nerf_signature_tpu_torch import api as t_api
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
    from test_torch_device_loop import H, P, W, WM_RAYS, _views, _wm_opt
    from test_torch_wm_ops import port_params, wm_cfgs, wm_params
    from test_torch_wm_train import GRID, wm_batch

    jw, tw = wm_cfgs()
    jw = dataclasses.replace(jw, ngp=dataclasses.replace(jw.ngp, **BG))
    tw = dataclasses.replace(tw, ngp=dataclasses.replace(tw.ngp, **BG))
    kw = dict(density_thresh=0.01, max_steps=64, grid_size=GRID, train_budget=16,
              infer_budget=16)
    jm, tm = j_api.WatermarkModel(jw, **kw), t_api.WatermarkModel(tw, device="cpu", **kw)
    p = wm_params(jw)
    p["backbone"]["bg_table"] = (p["backbone"]["bg_table"] * 1e4).astype(np.float32)
    jm.backbone = jax.tree_util.tree_map(jnp.asarray, p["backbone"])
    jm.trainable = jax.tree_util.tree_map(jnp.asarray, p["trainable"])
    tm.backbone, tm.trainable = port_params(p)
    occ = ball_occupancy(1.0, H=GRID)
    jm.occ = jm.occ._replace(occupancy=jnp.asarray(occ))
    tm.occ = tm.occ._replace(occupancy=T(occ))
    opt = _wm_opt(distortion="none")
    jt = j_twm.WatermarkTrainer("wm", opt, jm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    tt = t_twm.WatermarkTrainer("wm", opt, tm, workspace=None, use_checkpoint="scratch",
                                mute=True)
    ro_b, rd_b, *_ = wm_batch(seed=3)
    poses, images, intr = _views(3, seed=5)
    key = jax.random.PRNGKey(21)
    n_steps, D = 3, tw.message_dim
    (jtr, _, lj, lwj, lij) = j_twm._wm_device_loop(
        jm.backbone, jm.trainable, jt.opt_state, jm.occ.occupancy, jnp.asarray(ro_b),
        jnp.asarray(rd_b), jnp.asarray(poses), jnp.asarray(images.reshape(P, -1, 3)),
        jnp.asarray(intr), key, jnp.float32(opt.lambda_w), jnp.float32(opt.lambda_i),
        jt.wcfg_train, jm.rc, jt.content_budget, jm.infer_budget, jt.optimizer.update,
        "none", "bce", n_steps, WM_RAYS, H, W)
    msg, pidx, pix = [], [], []
    for k in jax.random.split(key, n_steps):
        km, kp, ki, _ = jax.random.split(k, 4)
        msg.append(np.asarray(jax.random.randint(km, (D,), 0, 2)))
        pidx.append(int(jax.random.randint(kp, (), 0, P)))
        pix.append(np.asarray(jax.random.randint(ki, (WM_RAYS,), 0, H * W)))
    draws = t_dl.WmDraws(T(np.stack(msg).astype(np.int32)), torch.tensor(pidx),
                         T(np.stack(pix).astype(np.int64)), None)
    data = t_dl.preload(poses, images, intr, H, W, "cpu")
    lt, lwt, lit = t_dl.wm_device_loop(tt, data, T(np.ascontiguousarray(ro_b)),
                                       T(np.ascontiguousarray(rd_b)), n_steps, draws=draws)
    for a, b in ((lt, lj), (lwt, lwj), (lit, lij)):
        np.testing.assert_allclose(a[:1], np.asarray(b)[:1], rtol=1e-5)
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3)
    assert rel_l2(tm.trainable["msg_tables"].detach().numpy(),
                  np.asarray(jtr["msg_tables"])) <= 1e-2


# ------------------------------------------------- checkpoints and CLIs
def test_params_to_jax_and_back_carry_the_bg_leaves(tmp_path):
    """params_from_jax / params_to_jax round-trip bg_table and bg_net; a
    full checkpoint the port writes after a step resumes in JAX with the
    bg leaves and their Adam moments, and one JAX writes in the port."""
    import types

    from nerf_signature_tpu.train import trainer as j_trainer

    jm, tm = bg_models()
    back = t_ckpt.params_to_jax(tm.params)
    assert set(back) == {"hash_table", "sigma_net", "color_net", "bg_table", "bg_net"}
    again = t_ckpt.params_from_jax(back)
    for a, b in zip(t_trainer.param_leaves(again), t_trainer.param_leaves(tm.params)):
        assert torch.equal(a, b)
    opt = types.SimpleNamespace(lr=1e-2, iters=100, max_ray_batch=128, devices=1, patch_size=1,
                                num_rays=256, max_steps=128, compact_frac=-1, group_budget=-1,
                                update_extra_interval=16)
    ro, rd, images = _batch(seed=2)
    for direction in ("port_to_jax", "jax_to_port"):
        ws = str(tmp_path / direction)
        jm, tm = bg_models()
        if direction == "port_to_jax":
            tt = t_trainer.Trainer("ngp", opt, tm, workspace=ws, use_checkpoint="scratch",
                                   mute=True)
            bg, _ = tt.draws(ro.shape[0], True)
            tt._train_step(T(ro), T(rd), T(images), bg, torch.rand(ro.shape[0]), tm.rc, BUDGET)
            tt.epoch = 1
            tt.save_checkpoint(full=True)
            jt = j_trainer.Trainer("ngp", opt, jm, workspace=ws, use_checkpoint="latest",
                                   mute=True)
        else:
            jt = j_trainer.Trainer("ngp", opt, jm, workspace=ws, use_checkpoint="scratch",
                                   mute=True)
            out = j_trainer._train_step(
                jm.params, jt.ema_params, jt.opt_state, jm.occ.occupancy, jnp.asarray(ro),
                jnp.asarray(rd), jnp.asarray(images), jax.random.PRNGKey(1), jm.cfg, jm.rc,
                BUDGET, jt.optimizer.update, True, jt.ema_decay)
            jm.params, jt.ema_params, jt.opt_state = out[:3]
            jt.epoch = 1
            jt.save_checkpoint(full=True)
            tt = t_trainer.Trainer("ngp", opt, tm, workspace=ws, use_checkpoint="latest",
                                   mute=True)
        assert tt.opt_count() == int(jt.opt_state[0].count) == 1
        for a, b in zip(leaves_j(jm.params), leaves_t(tm.params)):
            assert np.array_equal(a, b)
        mu_t = [tt.optimizer.state[p]["exp_avg"].numpy()
                for p in t_trainer.param_leaves(tm.params)]
        for a, b in zip(leaves_j(jt.opt_state[0].mu), mu_t):
            assert np.array_equal(a, b)
        assert np.abs(mu_t[6]).sum() > 0  # the bg table's moment


def test_clis_train_with_the_bg_model(tmp_path):
    """``main_nerf --cpu --bg_radius 8`` per step and through the loop,
    then ``main_nerf_wtmk --cpu --bg_radius 8`` on that backbone (its
    checkpoint carries the bg leaves)."""
    import glob
    import os

    from nerf_signature_tpu_torch import main_nerf as t_main
    from nerf_signature_tpu_torch import main_nerf_wtmk as t_main_wm
    from test_torch_device_loop import _jax_reads
    from test_torch_stochastic_hash import write_image_scene
    from test_torch_wm_io import _cli_flags

    scene = write_image_scene(tmp_path)
    bg = ["--bg_radius", str(RADIUS)]
    base = [scene, "--cpu", "-O", "--iters", "4", "--grid_size", "16", "--num_rays", "32",
            "--bound", "1.0", "--scale", "1.0", "--dt_gamma", "0", "--min_near", "0.05",
            "--density_thresh", "0.01", "--train_budget", "16", "--infer_budget", "16",
            "--max_steps", "64", "--n_levels", "2"] + bg
    for name, extra in (("step", []), ("loop", ["--steps_per_dispatch", "2"])):
        ws = str(tmp_path / name)
        assert t_main.main(base + ["--workspace", ws] + extra) == 0
        assert "[eval]" in open(os.path.join(ws, "log_ngp.txt")).read()
    ckpt = sorted(glob.glob(str(tmp_path / "step" / "checkpoints" / "ngp_ep*.ckpt")))[-1]
    assert {"bg_table", "bg_net"} <= set(_jax_reads(ckpt)["params"])
    ws = str(tmp_path / "wm")
    flags = _cli_flags(scene, ws, ckpt, iters=4) + bg + ["--num_rays", "32", "--n_levels", "2"]
    assert t_main_wm.main(flags) == 0
    ckpts = sorted(glob.glob(os.path.join(ws, "checkpoints", "ngp_ep*.ckpt")))
    assert int(_jax_reads(ckpts[-1])["global_step"]) == 4
