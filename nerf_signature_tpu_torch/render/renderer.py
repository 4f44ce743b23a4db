"""Occupancy-grid volume renderer (counterpart of
``nerf_signature_tpu/render/renderer.py:render_rays_occ``).

One chunk of rays: slab test + march (K2) -> sample compaction (K5, with
``compact_frac``) -> field (K1 + K4, through ``field_fn``) -> composite
(K3) -> background blend (a colour, or the bg-sphere model's ``bg_fn``) and
normalised depth.  Training differentiates
through it (the kernels' autograd Functions).  The fixed-step path
(``render_rays_fixed``) is not ported yet.
"""

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..ops.compact import compact, uncompact
from ..ops.composite import composite_rays, composite_rays_plain
from ..ops.marching import march_rays_aabb

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
