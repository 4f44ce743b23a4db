"""Port parity for the render path and its state: ``render_rays_occ`` and
the staged ``NGPModel.render``, ``update_occupancy_grid`` (full and partial,
with the JAX draws handed over), ``packbits``, and the checkpoint format in
both directions.

Tolerances and why:
  * fp32 render: atol 1e-4 on the image.  The march selects the same
    samples (mask equality is held in test_torch_ops), the field agrees to
    ~1e-6, and the composite sums 32 weights in another order.
  * bf16 render: PSNR of port against JAX >= 40 dB.  A bf16 step (0.4%) in
    one layer's output moves a sample's sigma or colour by about that much.
  * grid densities: rtol 1e-4.  XLA contracts the jittered cell position
    ``xyz * (b - half) + jitter * half`` into an FMA, the port rounds both
    products; the ulp of position becomes ~1e-5 in the finest level's
    interpolation weights, which exp(h) carries into sigma.  Occupancy is
    equal except on cells whose density sits within that band of the
    threshold.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.api import NGPModel as JModel
from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu.ops import grid as j_grid
from nerf_signature_tpu.train import checkpoint as j_ckpt
from nerf_signature_tpu_torch.api import NGPModel as TModel
from nerf_signature_tpu_torch.data.rays import get_rays, rand_poses
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import grid as t_grid
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from test_torch_field import jax_params, small_cfgs

H_GRID = 32


def ball_occupancy(bound, H=H_GRID, radius=0.5):
    """[C, H, H, H] bool: cells whose centre lies in a ball, per cascade."""
    C = t_grid.num_cascades(bound)
    occ = np.zeros((C, H, H, H), bool)
    c = (np.arange(H) + 0.5) / H * 2 - 1
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    for cas in range(C):
        s = min(2**cas, bound)
        occ[cas] = (x**2 + y**2 + z**2) * s * s < radius**2
    return occ


def make_models(dtype, bound, budget=32):
    jcfg, tcfg = small_cfgs(dtype, bound)
    kw = dict(density_thresh=0.01, max_steps=128, grid_size=H_GRID, infer_budget=budget)
    jm = JModel(jcfg, **kw)
    tm = TModel(tcfg, device="cpu", **kw)
    pj = jax_params(jcfg)
    jm.params = jax.tree_util.tree_map(jnp.asarray, pj)
    tm.params = t_ckpt.params_from_jax(pj)
    occ = ball_occupancy(bound)
    jm.occ = jm.occ._replace(occupancy=jnp.asarray(occ))
    tm.occ = tm.occ._replace(occupancy=torch.from_numpy(occ))
    return jm, tm


def view_rays(bound, n=2, res=20, seed=0):
    rng = np.random.default_rng(seed)
    poses = rand_poses(rng, n, radius=2.2 * bound)
    fl = res / (2 * np.tan(0.4))
    return get_rays(poses, (fl, fl, res / 2, res / 2), res, res, -1)


def psnr(a, b):
    return -10 * np.log10(max(np.mean((a - b) ** 2), 1e-12))


@pytest.mark.parametrize("bound,prefilter", [(1.0, None), (2.0, None), (2.0, True),
                                             (1.0, False)])
def test_staged_render_matches_jax_fp32(bound, prefilter):
    jm, tm = make_models("fp32", bound)
    if prefilter is not None:
        jm.rc = jm.rc_eval = dataclasses.replace(jm.rc, prefilter=prefilter)
        tm.rc = tm.rc_eval = dataclasses.replace(tm.rc, prefilter=prefilter)
    rays = view_rays(bound)
    oj = jm.render(jnp.asarray(rays["rays_o"]), jnp.asarray(rays["rays_d"]),
                   staged=True, max_ray_batch=128)
    ot = tm.render(rays["rays_o"], rays["rays_d"], staged=True, max_ray_batch=128)
    img_j = np.asarray(oj["image"])
    img_t = ot["image"].numpy()
    assert img_t.shape == img_j.shape == (2, 400, 3)
    assert np.ptp(img_t) > 0.2  # the ball is in the picture
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ot["depth"].numpy(), np.asarray(oj["depth"]), rtol=0, atol=1e-4)


def test_staged_render_matches_jax_bf16_psnr():
    jm, tm = make_models("bf16", 1.0)
    rays = view_rays(1.0, n=1, res=24, seed=1)
    oj = jm.render(jnp.asarray(rays["rays_o"]), jnp.asarray(rays["rays_d"]),
                   staged=True, max_ray_batch=128)
    ot = tm.render(rays["rays_o"], rays["rays_d"], staged=True, max_ray_batch=128)
    assert psnr(ot["image"].numpy(), np.asarray(oj["image"])) >= 40.0


def test_unstaged_render_keeps_counts_and_weights_sum():
    jm, tm = make_models("fp32", 2.0)
    rays = view_rays(2.0, n=1, res=12)
    oj = jm.render(jnp.asarray(rays["rays_o"][0]), jnp.asarray(rays["rays_d"][0]))
    ot = tm.render(rays["rays_o"][0], rays["rays_d"][0])
    np.testing.assert_allclose(ot["weights_sum"].numpy(), np.asarray(oj["weights_sum"]),
                               rtol=0, atol=1e-4)
    assert np.array_equal(tm._last_n_occupied.numpy(), np.asarray(jm._last_n_occupied))
    assert np.array_equal(tm._last_n_groups_occ.numpy(), np.asarray(jm._last_n_groups_occ))


def test_render_with_compaction_matches_uncompacted():
    _, tm = make_models("fp32", 1.0)
    rays = view_rays(1.0, n=1, res=12)
    ref = tm.render(rays["rays_o"][0], rays["rays_d"][0])["image"]
    tm.rc_eval = dataclasses.replace(tm.rc_eval, compact_frac=0.5)
    packed = tm.render(rays["rays_o"][0], rays["rays_d"][0])["image"]
    torch.testing.assert_close(packed, ref, rtol=0, atol=1e-6)


def test_aabb_crop_matches_jax():
    jm, tm = make_models("fp32", 1.0)
    crop = [-0.2, -1.0, -1.0, 1.0, 0.3, 1.0]
    jm.set_aabb_crop(crop)
    tm.set_aabb_crop(crop)
    rays = view_rays(1.0, n=1, res=12)
    oj = jm.render(jnp.asarray(rays["rays_o"][0]), jnp.asarray(rays["rays_d"][0]))
    ot = tm.render(rays["rays_o"][0], rays["rays_d"][0])
    np.testing.assert_allclose(ot["image"].numpy(), np.asarray(oj["image"]), rtol=0, atol=1e-4)


# --------------------------------------------------------------------- grid
def _jax_draws(key, C, H, full):
    """The numbers update_occupancy_grid draws inside JAX, per cascade."""
    draws = []
    n = H**3 // 4
    for _ in range(C):
        key, knoise, kcoord, kocc = jax.random.split(key, 4)
        npts = H**3 if full else 2 * n
        jitter = np.asarray(jax.random.uniform(knoise, (npts, 3), minval=-1.0, maxval=1.0))
        if full:
            draws.append(t_grid.GridDraws(torch.from_numpy(jitter)))
        else:
            rc = np.asarray(jax.random.randint(kcoord, (n, 3), 0, H, dtype=jnp.int32))
            u = np.asarray(jax.random.uniform(kocc, (n,)))
            draws.append(t_grid.GridDraws(torch.from_numpy(jitter),
                                          torch.from_numpy(rc), torch.from_numpy(u)))
    return draws


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_update_occupancy_grid_full_then_partial_matches_jax(bound):
    jcfg, tcfg = small_cfgs("fp32", bound)
    pj = jax_params(jcfg)
    pt = t_ckpt.params_from_jax(pj)
    pj_dev = jax.tree_util.tree_map(jnp.asarray, pj)

    def dens_j(x):
        return j_ngp.ngp_density(pj_dev, jcfg, x)["sigma"]

    def dens_t(x):
        return t_ngp.ngp_density(pt, tcfg, x)["sigma"]

    gj = j_grid.init_occupancy_grid(bound, H_GRID)
    gt = t_grid.init_occupancy_grid(bound, H_GRID)
    C = gt.density.shape[0]
    kw = dict(bound=bound, grid_size=H_GRID, density_thresh=5.0)
    for step, full in enumerate([True, False, False]):
        key = jax.random.PRNGKey(10 + step)
        gj = j_grid.update_occupancy_grid(gj, key, dens_j, full=full, **kw)
        gt = t_grid.update_occupancy_grid(gt, dens_t, full=full,
                                          draws=_jax_draws(key, C, H_GRID, full), **kw)
        dj, dt = np.asarray(gj.density), gt.density.numpy()
        np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gt.density_live.numpy(), np.asarray(gj.density_live),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(gt.mean_density), float(gj.mean_density), rtol=1e-5)
        thresh = min(float(gj.mean_density), 5.0)
        near_edge = np.abs(dj - thresh) <= 1e-4 * np.abs(thresh) + 1e-6
        occ_j = np.asarray(gj.occupancy).reshape(C, -1)
        occ_t = gt.occupancy.numpy().reshape(C, -1)
        assert np.array_equal(occ_j[~near_edge], occ_t[~near_edge])
        assert int(gt.iter_density) == step + 1
    frac = occ_t.mean()
    assert 0.0 < frac < 1.0


def test_render_grid_and_packbits_match_jax():
    rng = np.random.default_rng(0)
    occ = rng.uniform(size=(2, 8, 8, 8)) < 0.3
    dens = rng.uniform(-1, 30, size=(2, 512)).astype(np.float32)
    gj = j_grid.init_occupancy_grid(2.0, 8)._replace(occupancy=jnp.asarray(occ),
                                                     density_live=jnp.asarray(dens))
    gt = t_grid.init_occupancy_grid(2.0, 8)._replace(occupancy=torch.from_numpy(occ),
                                                     density_live=torch.from_numpy(dens))
    assert np.array_equal(np.asarray(j_grid.render_grid(gj, 1e-5)),
                          t_grid.render_grid(gt, 1e-5).numpy())
    assert t_grid.render_grid(gt) is gt.occupancy
    flat = occ.reshape(-1)
    assert np.array_equal(np.asarray(j_grid.packbits(jnp.asarray(flat))),
                          t_grid.packbits(torch.from_numpy(flat)).numpy())
    with pytest.raises(NotImplementedError, match="training slice"):
        t_grid.mark_untrained_grid(gt, None, None)


# --------------------------------------------------------------- checkpoints
def j_ngp_init(jcfg):
    return j_ngp.init_ngp_params(jax.random.PRNGKey(1), jcfg)


def _jax_tree():
    """A JAX init_ngp_params tree in checkpoint (state-dict) form."""
    jcfg, _ = small_cfgs("fp32")
    return jax.tree_util.tree_map(
        np.asarray, j_ckpt.serialization.to_state_dict(j_ngp_init(jcfg)))


def test_params_from_jax_then_to_jax_is_identity():
    tree = _jax_tree()
    back = t_ckpt.params_to_jax(t_ckpt.params_from_jax(tree))
    assert sorted(back) == sorted(tree)
    for k in tree:
        a, b = tree[k], back[k]
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for i in a:
                assert b[i].dtype == np.float32 and np.array_equal(a[i], b[i])
        else:
            assert np.array_equal(a, b)
    # the list form (init_ngp_params itself) reads the same
    jcfg, _ = small_cfgs("fp32")
    raw = jax.tree_util.tree_map(np.asarray, j_ngp_init(jcfg))
    from_list = t_ckpt.params_from_jax(raw)
    assert torch.equal(from_list["sigma_net"][1], torch.from_numpy(tree["sigma_net"]["1"]))


def test_checkpoint_jax_writes_port_reads(tmp_path):
    jm, tm = make_models("fp32", 2.0)
    jm.occ = jm.occ._replace(iter_density=jnp.asarray(7, jnp.int32),
                             mean_density=jnp.asarray(1.5, jnp.float32))
    path = str(tmp_path / "ngp_ep0003.ckpt")
    j_ckpt.save_checkpoint(path, {"params": jm.params, "ema_params": jm.params,
                                  "occ": jm.occ._asdict(), "epoch": 3,
                                  "global_step": 30, "train_budget": 64})
    raw = t_ckpt.load_checkpoint(path)
    pt = t_ckpt.params_from_jax(raw["params"])
    t_ckpt.check_params_like(tm.params, pt)
    assert torch.equal(pt["hash_table"], torch.from_numpy(np.asarray(jm.params["hash_table"])))
    assert int(raw["occ"]["iter_density"]) == 7 and raw["epoch"] == 3
    assert t_ckpt.latest_checkpoint(str(tmp_path), "ngp") == path
    with pytest.raises(ValueError, match="shape mismatch"):
        _, small = make_models("fp32", 2.0)
        small.params["sigma_net"][0] = small.params["sigma_net"][0][:4]
        t_ckpt.check_params_like(small.params, pt)


def test_checkpoint_port_writes_jax_reads(tmp_path):
    jm, tm = make_models("fp32", 2.0)
    tm.occ = tm.occ._replace(iter_density=torch.tensor(5, dtype=torch.int32))
    path = str(tmp_path / "ngp_ep0001.ckpt")
    t_ckpt.save_checkpoint(path, {"params": tm.params, "ema_params": tm.params,
                                  "occ": tm.occ, "epoch": 1, "global_step": 10,
                                  "train_budget": 32})
    raw = j_ckpt.load_checkpoint(path)
    fresh = JModel(jm.cfg, grid_size=H_GRID)
    restored = j_ckpt.restore_like(fresh.params, raw["params"])
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(jm.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    occ = {k: j_ckpt.restore_like(getattr(fresh.occ, k), v) for k, v in raw["occ"].items()}
    assert np.array_equal(np.asarray(occ["occupancy"]), tm.occ.occupancy.numpy())
    assert int(occ["iter_density"]) == 5
    assert os.path.getsize(path) > 0
