"""Volume renderer (counterpart of ``nerf_signature_tpu/render/renderer.py``):
the occupancy-grid path and the fixed-step path.

``render_rays_occ``, one chunk of rays: slab test + march (K2) -> sample
compaction (K5, with ``compact_frac``) -> field (K1 + K4, through
``field_fn``) -> composite (K3) -> background blend (a colour, or the
bg-sphere model's ``bg_fn``) and normalised depth.  Training differentiates
through it (the kernels' autograd Functions).

``render_rays_fixed`` (``cuda_ray`` off): ``num_steps`` samples spaced
evenly in [near, far], optionally jittered, and with ``upsample_steps > 0``
as many more drawn from the coarse weights (``ops/pdf.py``); the field (K1 +
K4) on each set, the stable merge by depth, then K3 with no early exit.
"""

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..ops.compact import compact, uncompact
from ..ops.composite import composite_rays, composite_rays_plain
from ..ops.intersect import near_far_from_aabb
from ..ops.marching import march_rays_aabb
from ..ops.pdf import sample_pdf

_MISS = 3.0e38  # rays that miss the AABB carry the float32-max sentinel


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    bound: float = 1.0
    grid_size: int = 128
    density_scale: float = 1.0
    min_near: float = 0.2
    dt_gamma: float = 0.0
    max_steps: int = 1024
    T_thresh: float = 1e-4
    num_steps: int = 128
    upsample_steps: int = 0
    bg_radius: float = -1.0
    compact_frac: float = 0.0
    prefilter: Optional[bool] = None
    group_budget: int = 0
    t_cull: float = 0.0


def default_aabb(rc: RenderConfig):
    b = float(rc.bound)
    return (-b, -b, -b, b, b, b)


def render_rays_occ(field_fn: Callable, occupancy, rays_o, rays_d,
                    rc: RenderConfig, *, budget: int, bg_color=1.0,
                    n_cand: Optional[int] = None, aabb=None, coarse=None,
                    noise=None, plain=False, bg_fn: Optional[Callable] = None):
    """Occupancy-grid render of [N, 3] rays, differentiable in what
    ``field_fn`` closes over (the train step's params).

    ``field_fn(xyzs [M, 3], dirs [M, 3]) -> (sigma [M], rgb [M, 3])``.
    ``occupancy``: the bool grid, or with ``rc.t_cull > 0`` the float render
    grid (``ops/grid.py:render_grid``).
    ``bg_color``: a scalar, [1, 3] or a per-ray [N, 3] tensor;
    ``bg_fn(rays_o, rays_d) -> [N, 3]``, when given, overrides it (the
    bg-sphere model, ``models/ngp.py:background_fn``).  ``noise``:
    optional [N] U[0, 1) march perturbation (training; JAX draws it from
    ``perturb_key``).  ``aabb``: optional [6] crop box (default: the scene
    bound).  ``coarse``: the prefilter's dilated coarse grid, built once per
    render by the caller (built here when None).  ``plain=True`` runs the
    plain versions of the marcher, the compaction and the compositor
    whatever the device.
    Returns dict(image [N, 3], depth [N], weights_sum [N], n_occupied,
    n_occupied_raw, n_groups_occ [N])."""
    if aabb is None:
        aabb = default_aabb(rc)
    m = march_rays_aabb(
        rays_o, rays_d, aabb, occupancy, min_near=rc.min_near, bound=rc.bound,
        dt_gamma=rc.dt_gamma, max_steps=rc.max_steps, n_cand=n_cand,
        budget=budget, prefilter=rc.prefilter,
        group_budget=rc.group_budget or None, coarse=coarse, noise=noise,
        t_cull=rc.t_cull, plain=plain,
    )
    nears, fars = m["nears"], m["fars"]
    N, S = m["mask"].shape

    Mc = 0
    if rc.compact_frac > 0:
        Mc = min(int(math.ceil(N * S * rc.compact_frac / 1024.0)) * 1024, N * S)
    if 0 < Mc < N * S:
        # pack the occupied samples of the whole batch into Mc slots (K5),
        # run the field there, scatter the results back
        comp = compact(m["mask"], m["xyzs"], rays_d, Mc, plain=plain)
        sig_c, rgb_c = field_fn(comp.xyz_c, comp.dir_c)
        sigmas, rgbs = uncompact(sig_c, rgb_c, comp)
    else:
        sigmas, rgbs = field_fn(m["xyzs"].reshape(-1, 3), m["dirs"].reshape(-1, 3))
    sigmas = sigmas.reshape(N, S) * rc.density_scale
    rgbs = rgbs.reshape(N, S, 3)

    composite = composite_rays_plain if plain else composite_rays
    out = composite(sigmas, rgbs, m["deltas"], m["ts"], mask=m["mask"],
                    T_thresh=rc.T_thresh)
    ws = out["weights_sum"]
    if bg_fn is not None:
        bg_color = bg_fn(rays_o, rays_d)
    image = out["image"] + (1.0 - ws)[..., None] * bg_color
    hit = nears < _MISS
    span = torch.where(hit, torch.clamp_min(fars - nears, 1e-6), 1.0)
    depth = torch.where(hit, torch.clamp_min(out["depth"] - nears * ws, 0.0) / span, 0.0)
    return {
        "image": image,
        "depth": depth,
        "weights_sum": ws,
        "n_occupied": m["n_occupied"],
        "n_occupied_raw": m["n_occupied_raw"],
        "n_groups_occ": m["n_groups_occ"],
    }


def render_rays_fixed(field_fn: Callable, rays_o, rays_d, rc: RenderConfig, *,
                      bg_color=1.0, noise=None, u_upsample=None, aabb=None,
                      plain=False, bg_fn: Optional[Callable] = None):
    """Fixed-step render of [N, 3] rays (JAX ``render_rays_fixed``).

    ``field_fn(xyzs [M, 3], dirs [M, 3]) -> (sigma [M], rgb [M, 3])``.
    ``noise``: optional [N, num_steps] U[0, 1) jitter of the evenly spaced
    samples (JAX's ``perturb_key``).  ``u_upsample``: [N, upsample_steps]
    U[0, 1) draws of the pdf upsample, or None for its deterministic
    midpoints (JAX's ``det_upsample``).  ``aabb``, ``bg_color``, ``bg_fn``
    and ``plain`` as in ``render_rays_occ``.

    JAX queries density on the coarse and the fine samples and colour once
    on the merged set; here K4 gives sigma and rgb together on each set and
    both follow the merge's order.  A sample's colour depends only on its
    position and its ray's direction, so the result is the same.
    Returns dict(image [N, 3], depth [N], weights_sum [N])."""
    if aabb is None:
        aabb = default_aabb(rc)
    N = rays_o.shape[0]
    T = rc.num_steps
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, rc.min_near)
    hit = nears < _MISS
    nears_ = torch.where(hit, nears, 0.0)
    fars_ = torch.where(hit, fars, 1.0)

    z = torch.linspace(0.0, 1.0, T, dtype=torch.float32, device=rays_o.device)
    z_vals = nears_[:, None] + (fars_ - nears_)[:, None] * z[None, :]
    sample_dist = (fars_ - nears_)[:, None] / T
    if noise is not None:
        z_vals = z_vals + (noise - 0.5) * sample_dist

    def query(zv):
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None]
        xyz = torch.clamp(xyz, -rc.bound, rc.bound)
        dirs = rays_d[:, None, :].expand(xyz.shape)
        sigma, rgb = field_fn(xyz.reshape(-1, 3), dirs.reshape(-1, 3))
        return sigma.reshape(N, -1), rgb.reshape(N, -1, 3)

    sigma, rgbs = query(z_vals)

    if rc.upsample_steps > 0:
        with torch.no_grad():  # the new samples carry no gradient (stop_gradient)
            deltas = torch.diff(z_vals, dim=-1)
            deltas = torch.cat([deltas, sample_dist], dim=-1)
            alphas = 1.0 - torch.exp(-deltas * rc.density_scale * sigma)
            shifted = torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-15], dim=-1)
            weights = alphas * torch.cumprod(shifted, dim=-1)[..., :-1]
            z_mid = z_vals[..., :-1] + 0.5 * deltas[..., :-1]
            new_z = sample_pdf(z_mid, weights[:, 1:-1], rc.upsample_steps,
                               det=u_upsample is None, u=u_upsample)
        new_sigma, new_rgbs = query(new_z)
        z_vals, order = torch.sort(torch.cat([z_vals, new_z], dim=-1), dim=-1, stable=True)
        sigma = torch.gather(torch.cat([sigma, new_sigma], dim=-1), -1, order)
        rgbs = torch.gather(torch.cat([rgbs, new_rgbs], dim=1), 1,
                            order[..., None].expand(-1, -1, 3))

    deltas = torch.diff(z_vals, dim=-1)
    deltas = torch.cat([deltas, sample_dist], dim=-1)
    composite = composite_rays_plain if plain else composite_rays
    out = composite(sigma * rc.density_scale, rgbs.contiguous(), deltas.contiguous(),
                    z_vals.contiguous(), mask=hit[:, None].expand(sigma.shape).contiguous(),
                    T_thresh=0.0)  # no early exit on the fixed-step path
    ws = out["weights_sum"]
    if bg_fn is not None:
        bg_color = bg_fn(rays_o, rays_d)
    image = out["image"] + (1.0 - ws)[..., None] * bg_color
    ori_z = torch.clamp((z_vals - nears_[:, None])
                        / torch.clamp_min((fars_ - nears_)[:, None], 1e-6), 0.0, 1.0)
    depth = torch.sum(out["weights"] * ori_z, dim=-1)
    return {"image": image, "depth": depth, "weights_sum": ws}
