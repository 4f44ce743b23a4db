"""High-level model object (counterpart of ``nerf_signature_tpu/api.py``):
params, occupancy grid and render options, with the staged chunked render.

The model lives on one device, ``"cuda"`` unless the caller passes
``device="cpu"``; with no GPU visible and no explicit CPU request it raises.
On the card every chunk goes through the four kernels (K2 marcher, K1 hash
encoder, K4 field heads, K3 compositor); on the CPU through their plain
versions.  ``WatermarkModel`` comes with the watermark slice.
"""

import dataclasses

import numpy as np
import torch

from .models.ngp import NGPConfig, field_params, init_ngp_params, ngp_density, ngp_field
from .ops.grid import init_occupancy_grid, num_cascades, render_grid, update_occupancy_grid
from .ops.marching import coarse_grid, march_plan
from .render.renderer import RenderConfig, render_rays_occ
from .utils.device import resolve_device


class NGPModel:
    """Clean instant-NGP model (params dict + occupancy grid + renderer)."""

    def __init__(self, cfg: NGPConfig = None, *, bound=1.0, cuda_ray=True,
                 density_scale=1.0, min_near=0.2, density_thresh=0.01,
                 bg_radius=-1.0, dt_gamma=0.0, max_steps=1024, grid_size=128,
                 seed=0, train_budget=128, infer_budget=256, num_steps=128,
                 upsample_steps=0, compact_frac=0.0, t_cull=0.0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or NGPConfig(bound=bound, density_scale=density_scale,
                                    bg_radius=bg_radius)
        if self.cfg.bg_radius > 0 or bg_radius > 0:
            raise NotImplementedError(
                "bg_radius > 0 needs the 2D hash encoder (ROADMAP queue 2 item "
                "K8), not ported yet")
        if not cuda_ray:
            raise NotImplementedError(
                "the fixed-step renderer (cuda_ray off) is not ported yet; the "
                "port renders through the occupancy grid (-O / --cuda_ray)")
        self.rc = RenderConfig(
            bound=self.cfg.bound, grid_size=grid_size, density_scale=density_scale,
            min_near=min_near, dt_gamma=dt_gamma, max_steps=max_steps,
            num_steps=num_steps, upsample_steps=upsample_steps,
            bg_radius=bg_radius, compact_frac=compact_frac, t_cull=t_cull)
        # renders are exact: t_cull is a train-step lever
        self.rc_eval = dataclasses.replace(self.rc, t_cull=0.0) if t_cull else self.rc
        self.cascade = num_cascades(self.rc.bound)
        self.density_thresh = density_thresh
        self.train_budget = train_budget
        self.infer_budget = infer_budget
        self.aabb_infer = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_ngp_params(torch.Generator().manual_seed(seed), self.cfg,
                                      self.device)
        self.occ = init_occupancy_grid(self.rc.bound, grid_size, self.device)

    # -- occupancy maintenance -------------------------------------------
    @torch.no_grad()
    def density_fn(self, x):
        """x [M, 3] world positions -> raw sigma [M] (K1 + K4 on the card)."""
        return ngp_density(field_params(self.params, self.cfg), self.cfg, x)["sigma"]

    def reset_extra_state(self):
        self.occ = init_occupancy_grid(self.rc.bound, self.rc.grid_size, self.device)

    def update_extra_state(self, decay=0.95, draws=None):
        """Full update for the first 16 updates, partial after.  Random draws
        come from ``self.generator`` unless ``draws`` is given."""
        full = int(self.occ.iter_density) < 16
        fp = field_params(self.params, self.cfg)
        self.occ = update_occupancy_grid(
            self.occ, lambda x: ngp_density(fp, self.cfg, x)["sigma"],
            bound=self.rc.bound, grid_size=self.rc.grid_size,
            density_scale=self.rc.density_scale,
            density_thresh=self.density_thresh, decay=decay, full=full,
            draws=draws, generator=self.generator)

    def set_aabb_crop(self, bounds):
        """Set (or clear with None) the inference crop box, clamped to the
        scene bound."""
        if bounds is None:
            self.aabb_infer = None
            return
        b = self.rc.bound
        lo = np.clip(np.asarray(bounds[:3], np.float32), -b, b)
        hi = np.clip(np.asarray(bounds[3:], np.float32), -b, b)
        hi = np.maximum(hi, lo + 1e-4)
        self.aabb_infer = tuple(float(v) for v in np.concatenate([lo, hi]))

    # -- rendering ----------------------------------------------------------
    @torch.no_grad()
    def render(self, rays_o, rays_d, *, staged=False, max_ray_batch=4096,
               bg_color=None, perturb=False, budget=None, plain=False, **_):
        """rays_o/d: [..., 3] arrays or tensors.  Returns dict of tensors on
        the model's device with the leading shape restored.  ``staged``
        renders 4096-ray chunks (tail padded with ones), like the JAX
        package's staged path.  ``plain=True`` runs the plain versions of
        every kernel (how the kernel path is checked on the card)."""
        if perturb:
            raise NotImplementedError(
                "perturbed (training) renders land with the training slice")
        rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=self.device)
        rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=self.device)
        prefix = rays_o.shape[:-1]
        rays_o = rays_o.reshape(-1, 3).contiguous()
        rays_d = rays_d.reshape(-1, 3).contiguous()
        N = rays_o.shape[0]
        if bg_color is None:
            bg = torch.ones((1, 3), dtype=torch.float32, device=self.device)
        else:
            bg = torch.as_tensor(bg_color, dtype=torch.float32,
                                 device=self.device).reshape(-1, 3)
        budget = budget or self.infer_budget

        # once per render: the gather-dtype table, the packed MLP weights,
        # the bool grid and the prefilter's dilated coarse grid
        rc = self.rc_eval
        fp = field_params(self.params, self.cfg)
        grid = render_grid(self.occ, rc.t_cull)
        plan = march_plan(grid.shape[0], grid.shape[1], bound=rc.bound,
                          dt_gamma=rc.dt_gamma, max_steps=rc.max_steps,
                          budget=budget, prefilter=rc.prefilter,
                          group_budget=rc.group_budget or None)
        coarse = coarse_grid(grid, plan)

        def chunk(ro, rd, bg_c):
            return render_rays_occ(
                lambda x, d: ngp_field(fp, self.cfg, x, d, plain=plain),
                grid, ro, rd, rc, budget=budget, bg_color=bg_c,
                aabb=self.aabb_infer, coarse=coarse, plain=plain)

        if staged and N > max_ray_batch:
            pad = (-N) % max_ray_batch
            if pad:
                ones = torch.ones((pad, 3), dtype=torch.float32, device=self.device)
                rays_o = torch.cat([rays_o, ones], 0)
                rays_d = torch.cat([rays_d, ones], 0)
            if bg.shape[0] > 1 and pad:
                bg = torch.cat([bg, torch.ones((pad, 3), dtype=torch.float32,
                                               device=self.device)], 0)
            images, depths = [], []
            for h in range(0, N + pad, max_ray_batch):
                bg_c = bg[h:h + max_ray_batch] if bg.shape[0] > 1 else bg
                out = chunk(rays_o[h:h + max_ray_batch], rays_d[h:h + max_ray_batch], bg_c)
                images.append(out["image"])
                depths.append(out["depth"])
            results = {"image": torch.cat(images, 0)[:N], "depth": torch.cat(depths, 0)[:N]}
        else:
            out = chunk(rays_o, rays_d, bg)
            results = {k: out[k] for k in ("image", "depth", "weights_sum")}
            self._last_n_occupied = out["n_occupied"]
            self._last_n_groups_occ = out["n_groups_occ"]
        results["image"] = results["image"].reshape(*prefix, 3)
        results["depth"] = results["depth"].reshape(*prefix)
        if "weights_sum" in results:
            results["weights_sum"] = results["weights_sum"].reshape(*prefix)
        return results
