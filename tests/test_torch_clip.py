"""Port parity of the CLIP guidance: ``utils/clip_loss.py`` (the vision
tower from a ``transformers`` model, JAX's resize, the guidance loss and its
image gradient), the GT-free train step and the trainer's branches, each
against the JAX package on the same inputs (CPU).  The vision tower is a
tiny random ``CLIPVisionModelWithProjection`` converted by both packages
(no weights ship with the repo, and none are fetched); the trainers get it
injected, as JAX's ``tests/test_clip_trainer.py`` does.

Tolerances and why:
  * features (unit vectors): 1e-6 absolute plus 1e-5 relative (measured
    3.0e-7 absolute); the loss 1e-5 relative (measured 6.1e-7); its image
    gradient 1e-4 relative L2 (measured 6.8e-7): the same fp32 products,
    summed in other orders by XLA's and oneDNN's kernels.
  * the resize: the weights within 2e-7 of JAX's (``compute_weight_mat``;
    XLA sums each column's few taps in another order), the port within 1e-6
    of the float64 contraction of JAX's weights, JAX's
    ``jax.image.resize`` within 3e-5 of the port (measured 1.3e-5: XLA's
    CPU einsum carries up to ~1e-5 of error itself, the port ~1e-7).
  * the GT-free step: each package marches its own samples (on JAX's noise);
    the masks are equal, positions differ by an ulp where XLA contracts
    into FMAs (``test_torch_train.py``'s end-to-end bounds, fp32).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.train import trainer as j_trainer
from nerf_signature_tpu.utils import clip_loss as j_clip
from nerf_signature_tpu_torch.data.rays import get_rays, rand_poses
from nerf_signature_tpu_torch.train import trainer as t_trainer
from nerf_signature_tpu_torch.utils import clip_loss as t_clip
from test_torch_render import make_models
from test_torch_train import _check_grads, leaves_j, leaves_t
from test_torch_train_ops import one_torch_thread, rel_l2  # noqa: F401

T = torch.from_numpy


def tiny_tower(act="quick_gelu", seed=0):
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=16,
                           projection_dim=16, hidden_act=act)
    torch.manual_seed(seed)
    return CLIPVisionModelWithProjection(cfg).eval()


@pytest.fixture(scope="module")
def towers():
    """act -> (JAX params, meta, port params, meta), one model each."""
    out = {}
    for act in ("quick_gelu", "gelu"):
        model = tiny_tower(act)
        pj, mj = j_clip.clip_vision_params_from_torch(model)
        pt, mt = t_clip.clip_vision_params_from_torch(model)
        out[act] = (pj, mj, pt, mt)
    return out


def text_vector(dim=16, seed=1):
    t = np.random.default_rng(seed).normal(size=(1, dim)).astype(np.float32)
    return t / np.linalg.norm(t)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_vision_features_match_jax(towers, act):
    pj, mj, pt, mt = towers[act]
    assert mt == mj
    # the JAX tree converted to the port's layout is the port's own tree
    pc, mc = t_clip.clip_vision_params_from_jax(pj, mj)
    assert mc == mj
    flat_c = jax.tree_util.tree_leaves(pc)
    flat_t = jax.tree_util.tree_leaves(pt)
    assert len(flat_c) == len(flat_t) and all(torch.equal(a, b) for a, b in zip(flat_c, flat_t))
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    fj = np.asarray(j_clip.clip_image_features(pj, mj, jnp.asarray(imgs)))
    ft = t_clip.clip_image_features(pt, mt, T(imgs)).numpy()
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(ft, axis=-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("shape,out", [((2, 64, 64, 3), (224, 224)),  # the CLI's 64 -> 224
                                       ((1, 300, 260, 3), (224, 224)),  # shrinking
                                       ((1, 40, 56, 3), (32, 48))])  # one axis each way
def test_resize_matches_jax_image_resize(shape, out):
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    x = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    rj = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0],) + out + (3,), "bilinear"))
    rt = t_clip.resize_bilinear(T(x), *out).numpy()
    assert rt.shape == rj.shape
    np.testing.assert_allclose(rt, rj, rtol=0, atol=3e-5)
    # the same weights as JAX's, contracted in float64: the port within 1e-6
    wh, ww = (np.asarray(compute_weight_mat(n, m, m / n, 0.0, _fill_triangle_kernel, True),
                         np.float64) for n, m in zip(shape[1:3], out))
    for i in range(2):  # equal but for the column sums' order (an ulp)
        np.testing.assert_allclose(t_clip._resize_weights(shape[1 + i], out[i]).numpy(),
                                   (wh, ww)[i], rtol=0, atol=2e-7)
    exact = np.einsum("bhwc,ho,wp->bopc", x.astype(np.float64), wh, ww, optimize=True)
    np.testing.assert_allclose(rt, exact, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [24, 48])
def test_guidance_loss_and_image_grad_match_jax(towers, size):
    """The loss from images smaller (upsampled to 32) and larger (shrunk,
    antialiased) than the tower's input, and its gradient to the image."""
    pj, mj, pt, mt = towers["quick_gelu"]
    text = text_vector()
    imgs = np.random.default_rng(size).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    lj, gj = jax.value_and_grad(lambda x: j_clip.clip_guidance_loss(
        pj, mj, jnp.asarray(text), x))(jnp.asarray(imgs))
    x = T(imgs).requires_grad_(True)
    lt = t_clip.clip_guidance_loss(pt, mt, T(text), x)
    lt.backward()
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    assert rel_l2(x.grad.numpy(), np.asarray(gj)) <= 1e-4
    assert float(x.grad.abs().max()) > 0


def gt_free_batch(s=16, seed=0):
    """A rand_pose bundle as the providers collate it: [1, s * s] rays."""
    poses = rand_poses(np.random.default_rng(seed), 1, radius=2.2)
    rays = get_rays(poses, (20.0, 20.0, s / 2, s / 2), s, s, -1)
    return {"H": s, "W": s, "rays_o": rays["rays_o"], "rays_d": rays["rays_d"]}


def _opt(**kw):
    d = dict(lr=1e-2, iters=100, max_ray_batch=128, devices=1, patch_size=1, num_rays=256,
             max_steps=128, compact_frac=0, group_budget=0, update_extra_interval=16,
             clip_text="")
    d.update(kw)
    return types.SimpleNamespace(**d)


def test_gt_free_clip_step_matches_jax(towers):
    """One GT-free step through each trainer (the tower injected), on JAX's
    march noise: the loss, the gradients (JAX's from the same loss function
    differentiated outside its jitted step) and the params after Adam."""
    pj, mj, pt, mt = towers["quick_gelu"]
    text = text_vector()
    jm, tm = make_models("fp32", 1.0)
    jm.train_budget = tm.train_budget = 32
    jt = j_trainer.Trainer("ngp", _opt(), jm, workspace=None, use_checkpoint="scratch",
                           mute=True)
    tt = t_trainer.Trainer("ngp", _opt(), tm, workspace=None, use_checkpoint="scratch",
                           mute=True)
    jt._clip = types.SimpleNamespace(available=True, params=pj, meta=mj,
                                     text_features=jnp.asarray(text))
    tt._clip = types.SimpleNamespace(params=pt, meta=mt, text_features=T(text))
    data = gt_free_batch()
    ro, rd = data["rays_o"].reshape(-1, 3), data["rays_d"].reshape(-1, 3)
    _, key = jax.random.split(jm.key)  # the key the JAX step takes (model._next_key)
    noise = np.asarray(jax.random.uniform(key, (ro.shape[0],)))

    def loss_j(p):
        from nerf_signature_tpu.models.ngp import ngp_field
        from nerf_signature_tpu.render.renderer import render_rays_occ

        out = render_rays_occ(lambda x, d: ngp_field(p, jm.cfg, x, d), jm.occ.occupancy,
                              jnp.asarray(ro), jnp.asarray(rd), jm.rc, budget=32,
                              bg_color=1.0, perturb_key=key)
        return j_clip.clip_guidance_loss(pj, mj, jnp.asarray(text),
                                         out["image"].reshape(1, 16, 16, 3))

    p0 = leaves_j(jm.params)
    _, gj = jax.value_and_grad(loss_j)(jm.params)
    gj = leaves_j(gj)
    lj = jt.train_step_data(data)[0]
    lt = tt._train_step_clip(T(ro), T(rd), 16, 16, T(noise))
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    _check_grads(gj, leaves_t(tm.params, grad=True), "fp32")
    assert tt.opt_count() == 1
    lr = t_trainer.make_lr_schedule(1e-2, 100)(0)
    for g, w0, a, b in zip(gj, p0, leaves_j(jm.params), leaves_t(tm.params)):
        sure = np.abs(g) > 1e-2 * np.sqrt(np.mean(g**2))
        np.testing.assert_allclose(b[sure], a[sure], rtol=0, atol=1e-6)
        np.testing.assert_allclose(b[sure], (w0 - lr * np.sign(g))[sure], rtol=0, atol=1e-6)
    # through train_step_data: the model's own draws; the table moves
    before = tm.params["hash_table"].detach().clone()
    loss, *rest = tt.train_step_data(data)
    assert np.isfinite(float(loss)) and rest == [None] * 4
    assert not torch.equal(before, tm.params["hash_table"])


def test_clip_branches_match_jax(monkeypatch, capsys):
    """Without ``transformers`` (or without the weights) ``--clip_text``
    raises JAX's RuntimeError up front; without ``--clip_text`` a GT-free
    batch is skipped with JAX's log line."""
    _, tm = make_models("fp32", 1.0)
    monkeypatch.setitem(sys.modules, "transformers", None)  # the import fails
    errors = []
    for trainer, model in ((j_trainer.Trainer, make_models("fp32", 1.0)[0]),
                           (t_trainer.Trainer, tm)):
        with pytest.raises(RuntimeError, match="CLIP weights unavailable") as e:
            trainer("ngp", _opt(clip_text="a red ball", clip_model="/no/such/model"), model,
                    workspace=None, use_checkpoint="scratch", mute=True)
        errors.append(str(e.value))
    assert errors[1] == errors[0] and "--clip_model" in errors[1]
    tt = t_trainer.Trainer("ngp", _opt(), tm, workspace=None, use_checkpoint="scratch")
    assert tt.train_step_data(gt_free_batch()) == (None,) * 5
    assert "[train] skipping GT-free rand_pose batches: no --clip_text configured" in capsys.readouterr().out
    # a GT-free batch in an epoch: skipped, no step taken, no adaptation
    tt.train_one_epoch([gt_free_batch()])
    assert tt.global_step == 0 and tt.opt_count() == 0
