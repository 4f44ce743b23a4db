"""High-level model objects (counterpart of ``nerf_signature_tpu/api.py``):
params, occupancy grid and render options, with the staged chunked render.

The model lives on one device, ``"cuda"`` unless the caller passes
``device="cpu"``; with no GPU visible and no explicit CPU request it raises.
On the card a table geometry the kernels lack (``check_kernel_geometry``,
e.g. 16 levels x 4 features) is refused before anything is built.
On the card every chunk goes through the kernels (K2 marcher, K1 hash
encoder, K4 field heads, K3 compositor, K9's effective table under a
message, or under ``--copyrnerf`` K4's density logit and K10's colour-MLP
input, and with ``bg_radius > 0`` K8's background sphere); on the CPU
through their plain versions.  With ``cuda_ray`` off the clean model
renders through the fixed-step path (K1 + K4 on evenly spaced samples, K3
with no early exit; the grid is neither updated nor marked), as JAX's does;
the watermarked model always marches its grid.  ``NGPModel`` is the clean model;
``WatermarkModel`` holds a frozen ``backbone`` and the ``trainable``
message tables (or CopyRNeRF MLP) and decoder, and renders with or without
a message.
"""

import dataclasses

import numpy as np
import torch

from .models.ngp import (
    NGPConfig,
    background_fn,
    bg_params,
    check_kernel_geometry,
    field_params,
    init_ngp_params,
    ngp_density,
    ngp_field,
)
from .models.watermark import (
    WatermarkConfig,
    init_watermark_params,
    wtmk_density,
    wtmk_field,
    wtmk_field_params,
)
from .ops.grid import (
    init_occupancy_grid,
    mark_untrained_grid,
    num_cascades,
    render_grid,
    update_occupancy_grid_,
)
from .ops.marching import coarse_grid, march_plan
from .render.renderer import RenderConfig, render_rays_fixed, render_rays_occ
from .utils.device import resolve_device


class _BaseModel:
    """Occupancy grid, render options, random generator and the staged
    render, shared by the clean and the watermarked model.  A subclass
    supplies ``_density_query``, ``_render_field`` and ``_bg_tree``."""

    def __init__(self, cfg: NGPConfig, rc: RenderConfig, *, device, seed, density_thresh,
                 train_budget, infer_budget, cuda_ray):
        if device is None or torch.device(device).type == "cuda":
            check_kernel_geometry(cfg)  # before anything is built
        self.device = resolve_device(device)
        self.use_occ = cuda_ray  # "cuda_ray" flag == occupancy-grid path
        self.rc = rc
        # renders are exact: t_cull is a train-step lever
        self.rc_eval = dataclasses.replace(rc, t_cull=0.0) if rc.t_cull else rc
        self.cascade = num_cascades(rc.bound)
        self.density_thresh = density_thresh
        self.train_budget = train_budget
        self.infer_budget = infer_budget
        self.aabb_infer = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.occ = init_occupancy_grid(rc.bound, rc.grid_size, self.device)

    def _density_query(self):
        """x [M, 3] -> raw sigma [M], with the per-query buffers built once."""
        raise NotImplementedError

    def _render_field(self, message, plain):
        """field_fn(x, d) -> (sigma, rgb) for one render."""
        raise NotImplementedError

    def _bg_tree(self):
        """The params holding the bg-sphere model's leaves."""
        raise NotImplementedError

    def _render_bg(self, plain):
        """bg_fn(rays_o, rays_d) -> [N, 3] of the bg-sphere model for one
        render (its table cast once), or None without one."""
        if self.cfg.bg_radius <= 0:
            return None
        return background_fn(bg_params(self._bg_tree(), self.cfg), self.cfg, plain)

    # -- occupancy maintenance -------------------------------------------
    @torch.no_grad()
    def density_fn(self, x):
        """x [M, 3] world positions -> raw sigma [M] (K1 + K4 on the card)."""
        return self._density_query()(x)

    def reset_extra_state(self):
        self.occ = init_occupancy_grid(self.rc.bound, self.rc.grid_size, self.device)

    @torch.no_grad()
    def update_extra_state(self, decay=0.95, draws=None, full=None, plain=False):
        """Full update for the first 16 updates, partial after (``full``
        given by a caller that counts them, so nothing is read back).  Random
        draws come from ``self.generator`` unless ``draws`` is given.  The
        grid's tensors are updated in place: a captured train step reads
        them.  On the card through K6's kernels (``plain=True``: its plain
        version, how the two are held against each other).  Without the
        occupancy grid (``cuda_ray`` off) it does nothing, as in JAX."""
        if not self.use_occ:
            return
        if full is None:
            full = int(self.occ.iter_density) < 16
        update_occupancy_grid_(
            self.occ, self._density_query(), bound=self.rc.bound,
            grid_size=self.rc.grid_size, density_scale=self.rc.density_scale,
            density_thresh=self.density_thresh, decay=decay, full=full,
            draws=draws, generator=self.generator, plain=plain)

    @torch.no_grad()
    def mark_untrained_grid(self, poses, intrinsics):
        """Mark cells no training camera sees as never occupied (-1);
        nothing without the occupancy grid."""
        if not self.use_occ:
            return
        self.occ = mark_untrained_grid(
            self.occ, torch.as_tensor(np.asarray(poses, np.float32), device=self.device),
            tuple(np.asarray(intrinsics, np.float64).tolist()),
            bound=self.rc.bound, grid_size=self.rc.grid_size)

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
    def render(self, rays_o, rays_d, message=None, *, staged=False, max_ray_batch=4096,
               bg_color=None, perturb=False, budget=None, plain=False, **_):
        """rays_o/d: [..., 3] arrays or tensors.  Returns dict of tensors on
        the model's device with the leading shape restored.  ``message``: the
        watermark bits (the watermarked model; the clean model ignores it).
        ``staged`` renders 4096-ray chunks (tail padded with ones), like the
        JAX package's staged path.  ``perturb`` jitters each ray's first
        sample with noise drawn from ``self.generator`` and marches with the
        train budget.  ``plain=True`` runs the plain versions of every kernel
        (how the kernel path is checked on the card).  The clean model with
        ``cuda_ray`` off renders through ``render_rays_fixed`` in the same
        chunk loop (perturbed: its jitter and upsample draws from
        ``self.generator``; else the deterministic upsample)."""
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
        budget = budget or (self.train_budget if perturb else self.infer_budget)

        # once per render: the gather-dtype tables, the packed MLP weights,
        # the bool grid and the prefilter's dilated coarse grid
        field = self._render_field(message, plain)
        bg_fn = self._render_bg(plain)
        if self._fixed_step():
            chunk = self._fixed_chunk(field, bg_fn, perturb, plain)
        else:
            chunk = self._occ_chunk(field, bg_fn, budget, perturb, plain)

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
            self._last_n_occupied = out.get("n_occupied")
            self._last_n_groups_occ = out.get("n_groups_occ")
        results["image"] = results["image"].reshape(*prefix, 3)
        results["depth"] = results["depth"].reshape(*prefix)
        if "weights_sum" in results:
            results["weights_sum"] = results["weights_sum"].reshape(*prefix)
        return results

    def _fixed_step(self):
        """Whether renders take the fixed-step path (the clean model with
        ``cuda_ray`` off; the watermarked model always marches its grid, as
        JAX's does)."""
        return False

    def _occ_chunk(self, field, bg_fn, budget, perturb, plain):
        rc = self.rc_eval
        grid = render_grid(self.occ, rc.t_cull)
        plan = march_plan(grid.shape[0], grid.shape[1], bound=rc.bound,
                          dt_gamma=rc.dt_gamma, max_steps=rc.max_steps,
                          budget=budget, prefilter=rc.prefilter,
                          group_budget=rc.group_budget or None)
        coarse = coarse_grid(grid, plan)

        def chunk(ro, rd, bg_c):
            noise = (torch.rand((ro.shape[0],), generator=self.generator, device=self.device)
                     if perturb else None)
            return render_rays_occ(field, grid, ro, rd, rc, budget=budget, bg_color=bg_c,
                                   aabb=self.aabb_infer, coarse=coarse, noise=noise,
                                   plain=plain, bg_fn=bg_fn)

        return chunk

    def _fixed_chunk(self, field, bg_fn, perturb, plain):
        rc = self.rc

        def chunk(ro, rd, bg_c):
            noise = u = None
            if perturb:
                n = ro.shape[0]
                noise = torch.rand((n, rc.num_steps), generator=self.generator,
                                   device=self.device)
                if rc.upsample_steps > 0:
                    u = torch.rand((n, rc.upsample_steps), generator=self.generator,
                                   device=self.device)
            return render_rays_fixed(field, ro, rd, rc, bg_color=bg_c, noise=noise,
                                     u_upsample=u, aabb=self.aabb_infer, plain=plain,
                                     bg_fn=bg_fn)

        return chunk


class NGPModel(_BaseModel):
    """Clean instant-NGP model (params dict + occupancy grid + renderer)."""

    def __init__(self, cfg: NGPConfig = None, *, bound=1.0, cuda_ray=True,
                 density_scale=1.0, min_near=0.2, density_thresh=0.01,
                 bg_radius=-1.0, dt_gamma=0.0, max_steps=1024, grid_size=128,
                 seed=0, train_budget=128, infer_budget=256, num_steps=128,
                 upsample_steps=0, compact_frac=0.0, t_cull=0.0, device=None):
        self.cfg = cfg or NGPConfig(bound=bound, density_scale=density_scale,
                                    bg_radius=bg_radius)
        rc = RenderConfig(
            bound=self.cfg.bound, grid_size=grid_size, density_scale=density_scale,
            min_near=min_near, dt_gamma=dt_gamma, max_steps=max_steps,
            num_steps=num_steps, upsample_steps=upsample_steps,
            bg_radius=bg_radius, compact_frac=compact_frac, t_cull=t_cull)
        super().__init__(self.cfg, rc, device=device, seed=seed, density_thresh=density_thresh,
                         train_budget=train_budget, infer_budget=infer_budget,
                         cuda_ray=cuda_ray)
        self.params = init_ngp_params(torch.Generator().manual_seed(seed), self.cfg,
                                      self.device)

    def _density_query(self):
        fp = field_params(self.params, self.cfg)
        return lambda x: ngp_density(fp, self.cfg, x)["sigma"]

    def _render_field(self, message, plain):
        fp = field_params(self.params, self.cfg)
        return lambda x, d: ngp_field(fp, self.cfg, x, d, plain=plain)

    def _bg_tree(self):
        return self.params

    def _fixed_step(self):
        return not self.use_occ


class WatermarkModel(_BaseModel):
    """Watermarked model: frozen ``backbone`` (NGP params) + ``trainable``
    (``msg_tables`` or, under ``copyrnerf``, ``msg_mlp``, and ``decoder``,
    which under ``whole_image`` or ``copyrnerf`` decodes all D bits from one
    image).  ``density_fn`` is message-free."""

    def __init__(self, wcfg: WatermarkConfig = None, *, bound=1.0, message_dim=16,
                 n_views=1, cuda_ray=True, density_scale=1.0, min_near=0.2,
                 density_thresh=0.01, bg_radius=-1.0, dt_gamma=0.0, max_steps=1024,
                 grid_size=128, seed=0, train_budget=128, infer_budget=256,
                 compact_frac=0.0, t_cull=0.0, device=None):
        self.wcfg = wcfg or WatermarkConfig(
            ngp=NGPConfig(bound=bound, density_scale=density_scale, bg_radius=bg_radius),
            message_dim=message_dim, n_views=n_views)
        rc = RenderConfig(
            bound=self.wcfg.ngp.bound, grid_size=grid_size, density_scale=density_scale,
            min_near=min_near, dt_gamma=dt_gamma, max_steps=max_steps,
            bg_radius=bg_radius, compact_frac=compact_frac, t_cull=t_cull)
        super().__init__(self.wcfg.ngp, rc, device=device, seed=seed,
                         density_thresh=density_thresh, train_budget=train_budget,
                         infer_budget=infer_budget, cuda_ray=cuda_ray)
        p = init_watermark_params(torch.Generator().manual_seed(seed), self.wcfg, self.device)
        self.backbone = p["backbone"]
        self.trainable = p["trainable"]

    @property
    def cfg(self):
        return self.wcfg.ngp

    def field_params(self, message=None, plain=False):
        """``wtmk_field_params`` of the current backbone, trainable and
        message (differentiable in the msg tables under autograd)."""
        return wtmk_field_params(self.backbone, self.trainable, self.wcfg, message, plain)

    def _density_query(self):
        fp = self.field_params()
        return lambda x: wtmk_density(fp, self.wcfg, x)["sigma"]

    def _render_field(self, message, plain):
        fp = self.field_params(message, plain)
        return lambda x, d: wtmk_field(fp, self.wcfg, x, d, plain=plain)

    def _bg_tree(self):
        return self.backbone
