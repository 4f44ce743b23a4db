"""Port parity of the fixed-step renderer (``cuda_ray`` off):
``ops/pdf.py:sample_pdf``, ``render/renderer.py:render_rays_fixed`` and
``NGPModel(cuda_ray=False).render``, each against the JAX package on the
same inputs (CPU: the plain versions of K1, K4 and K3), and what training
with ``cuda_ray`` off does in each package.

JAX's draws are handed over: ``_render_fixed_clean`` splits its key into
``k1, k2``; the jitter is ``uniform(k1, [N, num_steps])`` and the upsample
uniforms ``uniform(k2, [N, upsample_steps])``.

Tolerances and why:
  * ``sample_pdf``: 5e-5 absolute on z in [0.5, 3.5] (measured 1.8e-5).
    XLA's cumsum on the CPU adds in another order than torch's (the cdf
    differs by up to 3e-7), and a draw's offset in its bin is that error
    over the bin's mass, times the bin's width; the bin each draw lands
    in is equal.
  * the renders: 1e-4 absolute on image and depth, as the occupancy-grid
    renders are held (``test_torch_render.py``): the samples' positions
    differ by an ulp where XLA contracts ``near + span * z`` and ``o + t *
    d`` into FMAs, the compositor sums in another order.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu import api as j_api
from nerf_signature_tpu.api import NGPModel as JModel
from nerf_signature_tpu.ops import pdf as j_pdf
from nerf_signature_tpu.train import trainer as j_trainer
from nerf_signature_tpu_torch.api import NGPModel as TModel
from nerf_signature_tpu_torch.ops import pdf as t_pdf
from nerf_signature_tpu_torch.render import renderer as t_render
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import trainer as t_trainer
from test_torch_field import jax_params, small_cfgs
from test_torch_render import H_GRID, view_rays
from test_torch_train_ops import one_torch_thread  # noqa: F401

T = torch.from_numpy
BG = dict(bg_radius=8.0, bg_n_levels=2, bg_log2_hashmap_size=10, bg_finest_resolution=64)


def fixed_models(num_steps=32, upsample_steps=0, bg=False, bound=1.0):
    """(JAX model, port model) with cuda_ray off at the tiny size, the same
    params (hash tables at U(+-1))."""
    jcfg, tcfg = small_cfgs("fp32", bound)
    if bg:
        jcfg, tcfg = dataclasses.replace(jcfg, **BG), dataclasses.replace(tcfg, **BG)
    kw = dict(cuda_ray=False, num_steps=num_steps, upsample_steps=upsample_steps,
              grid_size=H_GRID, max_steps=128, min_near=0.2)
    jm = JModel(jcfg, **kw)
    tm = TModel(tcfg, device="cpu", **kw)
    pj = jax_params(jcfg)
    if bg:
        pj["bg_table"] = (pj["bg_table"] * 1e4).astype(np.float32)
    jm.params = jax.tree_util.tree_map(jnp.asarray, pj)
    tm.params = t_ckpt.params_from_jax(pj)
    return jm, tm


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    rng = np.random.default_rng(0)
    B, Tn, n = 64, 33, 48
    bins = np.sort(rng.uniform(0.5, 3.5, size=(B, Tn)), axis=-1).astype(np.float32)
    weights = rng.uniform(size=(B, Tn - 1)).astype(np.float32)
    weights[:8] = 0.0  # all-empty rays: the 1e-5 floor makes their pdf uniform
    weights[8:16, 5:] = 0.0  # and bins of zero weight (denom < 1e-5 there)
    key = jax.random.PRNGKey(3)
    zj = np.asarray(j_pdf.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), n, det=det))
    u = None if det else T(np.asarray(jax.random.uniform(key, (B, n))))
    zt = t_pdf.sample_pdf(T(bins), T(weights), n, det=det, u=u).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=5e-5)
    assert np.array_equal(np.searchsorted(bins[0], zt[0]), np.searchsorted(bins[0], zj[0]))
    with pytest.raises(ValueError, match="uniforms"):
        t_pdf.sample_pdf(T(bins), T(weights), n)


CASES = {
    # name: (num_steps, upsample_steps, perturb, bg, crop)
    "coarse": (32, 0, False, False, None),
    "upsample_det": (16, 16, False, False, None),
    "upsample_perturbed": (16, 24, True, False, None),
    "bg_model": (24, 8, False, True, None),
    "aabb_crop": (24, 8, False, False, [-0.2, -1.0, -1.0, 1.0, 0.3, 1.0]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_rays_fixed_matches_jax(case):
    num_steps, up, perturb, bg, crop = CASES[case]
    jm, tm = fixed_models(num_steps, up, bg)
    rays = view_rays(1.0, n=1, res=12, seed=2)
    ro, rd = rays["rays_o"][0], rays["rays_d"][0]
    N = ro.shape[0]
    aabb = None if crop is None else jnp.asarray(crop, jnp.float32)
    key = jax.random.PRNGKey(7)
    oj = j_api._render_fixed_clean(jm.params, jnp.asarray(ro), jnp.asarray(rd),
                                   jnp.ones((1, 3)), key, jm.cfg, jm.rc, perturb, aabb=aabb)
    k1, k2 = jax.random.split(key)
    noise = T(np.asarray(jax.random.uniform(k1, (N, num_steps)))) if perturb else None
    u = T(np.asarray(jax.random.uniform(k2, (N, up)))) if perturb and up else None
    field = tm._render_field(None, False)
    ot = t_render.render_rays_fixed(field, T(ro), T(rd), tm.rc, bg_color=torch.ones((1, 3)),
                                    noise=noise, u_upsample=u, aabb=crop,
                                    bg_fn=tm._render_bg(False))
    img_j, img_t = np.asarray(oj["image"]), ot["image"].numpy()
    assert np.ptp(img_t) > 0.05  # the field is in the picture
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_fixed_model_staged_render_matches_jax():
    """``NGPModel(cuda_ray=False).render(staged=True)`` in 64-ray chunks (the
    tail padded), the deterministic upsample, against JAX's chunk loop."""
    jm, tm = fixed_models(16, 16)
    rays = view_rays(1.0, n=1, res=14, seed=4)  # 196 rays: 4 chunks, the last padded
    oj = jm.render(jnp.asarray(rays["rays_o"]), jnp.asarray(rays["rays_d"]), staged=True,
                   max_ray_batch=64)
    ot = tm.render(rays["rays_o"], rays["rays_d"], staged=True, max_ray_batch=64)
    assert ot["image"].shape == (1, 196, 3)
    np.testing.assert_allclose(ot["image"].numpy(), np.asarray(oj["image"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ot["depth"].numpy(), np.asarray(oj["depth"]), rtol=0, atol=1e-4)
    # unstaged, perturbed: the model's own draws, finite, no march counts
    out = tm.render(rays["rays_o"][0], rays["rays_d"][0], perturb=True)
    assert torch.isfinite(out["image"]).all() and tm._last_n_occupied is None


def _opt(**kw):
    d = dict(lr=1e-2, iters=100, max_ray_batch=128, devices=1, patch_size=1, num_rays=144,
             max_steps=128, compact_frac=0, group_budget=0, update_extra_interval=16)
    d.update(kw)
    return types.SimpleNamespace(**d)


def test_training_with_cuda_ray_off_trains_nothing_in_jax_and_is_refused():
    """JAX's Trainer with cuda_ray off: its step marches ``model.occ``, which
    starts empty and which ``update_extra_state`` and ``mark_untrained_grid``
    leave as it is, so two steps move no param (every ray renders the
    background).  The port refuses such training instead (ROADMAP queue 3),
    leaves the grid alone, and serves."""
    jm, tm = fixed_models(16, 0)
    jt = j_trainer.Trainer("ngp", _opt(), jm, workspace=None, use_checkpoint="scratch",
                           mute=True)
    rays = view_rays(1.0, n=1, res=12, seed=5)
    ro, rd = rays["rays_o"][0], rays["rays_d"][0]
    images = np.random.default_rng(5).uniform(size=(ro.shape[0], 4)).astype(np.float32)
    before = jax.tree_util.tree_map(np.asarray, jm.params)
    for step in range(2):
        jm.update_extra_state()
        loss = jt.train_step_data({"rays_o": ro, "rays_d": rd, "images": images})[0]
        assert np.isfinite(float(loss))
    assert not bool(jnp.any(jm.occ.occupancy)) and int(jm.occ.iter_density) == 0
    after = jax.tree_util.tree_map(np.asarray, jm.params)
    for a, b in zip(jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(after)):
        assert np.array_equal(a, b)

    tt = t_trainer.Trainer("ngp", _opt(), tm, workspace=None, use_checkpoint="scratch",
                           mute=True)
    batch = {"rays_o": ro, "rays_d": rd, "images": images}
    for run in (lambda: tt.train_step_data(batch), lambda: tt.train([batch]),
                lambda: tt.train_device(types.SimpleNamespace())):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
            run()
    density = tm.occ.density.clone()
    tm.update_extra_state()
    tm.mark_untrained_grid(np.eye(4, dtype=np.float32)[None, :3], (10.0, 10.0, 6.0, 6.0))
    assert torch.equal(tm.occ.density, density) and int(tm.occ.iter_density) == 0
    t_trainer.ensure_occupancy(tm, "no grid", print)  # no rebuild without the grid
    assert not bool(tm.occ.occupancy.any())
    out = tm.render(ro, rd)
    assert torch.isfinite(out["image"]).all()


def test_watermark_model_with_cuda_ray_off_still_marches_its_grid():
    """``WatermarkModel(cuda_ray=False)``: its renders march the grid (JAX's
    ``_render_chunk`` ignores ``use_occ``) and match JAX's under a message;
    its grid is neither updated nor marked."""
    from test_torch_wm_train import make_wm_models

    jm, tm = make_wm_models("fp32")
    jm.use_occ = tm.use_occ = False  # what cuda_ray=False sets
    rays = view_rays(1.0, n=1, res=10, seed=6)
    msg = np.array([1, 0, 1, 1], np.int32)[: tm.wcfg.message_dim]
    oj = jm.render(jnp.asarray(rays["rays_o"][0]), jnp.asarray(rays["rays_d"][0]), msg)
    ot = tm.render(rays["rays_o"][0], rays["rays_d"][0], msg)
    assert tm._last_n_occupied is not None and int(tm._last_n_occupied.sum()) > 0
    np.testing.assert_allclose(ot["image"].numpy(), np.asarray(oj["image"]), rtol=0, atol=1e-4)
    density = tm.occ.density.clone()
    tm.update_extra_state()
    assert torch.equal(tm.occ.density, density)
