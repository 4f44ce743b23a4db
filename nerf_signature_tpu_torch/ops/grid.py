"""Cascaded occupancy grid: state and maintenance (plain PyTorch; the density
queries go through the field's kernels).

Counterpart of ``nerf_signature_tpu/ops/grid.py``.  Cells are row-major
``(x*H + y)*H + z``; occupancy is a bool ``[C, H, H, H]`` tensor.  Every
random draw of an update is an explicit input (``GridDraws``) or comes from
the ``torch.Generator`` the caller passes, so a test can hand the port the
very numbers ``jax.random`` drew.
"""

import math
from typing import NamedTuple, Optional

import torch


class OccupancyGrid(NamedTuple):
    density: torch.Tensor       # [C, H**3] float32, -1 marks untrained cells
    occupancy: torch.Tensor     # [C, H, H, H] bool
    mean_density: torch.Tensor  # scalar float32
    iter_density: torch.Tensor  # scalar int32 (# updates so far)
    # most recent requeried cell density (no max-EMA): the t_cull proxy only
    density_live: Optional[torch.Tensor] = None  # [C, H**3] float32


class GridDraws(NamedTuple):
    """The random numbers of one cascade's update.  jitter: [n, 3] in
    [-1, 1); rand_coords: [n, 3] int cells (partial update only); occ_u:
    [n] in [0, 1) for the occupied-cell resample (partial update only)."""

    jitter: torch.Tensor
    rand_coords: Optional[torch.Tensor] = None
    occ_u: Optional[torch.Tensor] = None


def num_cascades(bound):
    """1 + ceil(log2(bound))."""
    return 1 + max(0, math.ceil(math.log2(bound)))


def init_occupancy_grid(bound, grid_size=128, device="cpu"):
    C, H = num_cascades(bound), grid_size
    return OccupancyGrid(
        density=torch.zeros((C, H**3), dtype=torch.float32, device=device),
        occupancy=torch.zeros((C, H, H, H), dtype=torch.bool, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=torch.zeros((), dtype=torch.int32, device=device),
        density_live=torch.zeros((C, H**3), dtype=torch.float32, device=device),
    )


def render_grid(grid: OccupancyGrid, t_cull=0.0):
    """The grid handed to the marcher: the bool occupancy at ``t_cull == 0``;
    otherwise a float grid, 0 on unoccupied cells and the live density on
    occupied ones (enables the t_cull proxy)."""
    if not t_cull > 0:
        return grid.occupancy
    C, H = grid.density.shape[0], grid.occupancy.shape[1]
    src = grid.density_live if grid.density_live is not None else grid.density
    return torch.where(grid.occupancy, torch.clamp_min(src.reshape(C, H, H, H), 0.0),
                       0.0).to(torch.float32)


def _cell_world_coords(coords, cas_bound, grid_size, jitter=None):
    """Grid cell -> (jittered) world position."""
    xyzs = 2.0 * coords.to(torch.float32) / (grid_size - 1) - 1.0
    half = cas_bound / grid_size
    cas_xyzs = xyzs * (cas_bound - half)
    if jitter is not None:
        cas_xyzs = cas_xyzs + jitter * half
    return cas_xyzs


def _linear_coords(grid_size, device):
    """All H^3 cell coords in row-major order, [H^3, 3] int64."""
    r = torch.arange(grid_size, device=device)
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def draw_grid_randomness(generator, C, H, full, device):
    """Per-cascade ``GridDraws`` from a ``torch.Generator`` on ``device``."""
    n = H**3 if full else 2 * (H**3 // 4)
    draws = []
    for _ in range(C):
        jitter = torch.rand((n, 3), generator=generator, device=device) * 2.0 - 1.0
        if full:
            draws.append(GridDraws(jitter))
        else:
            q = H**3 // 4
            coords = torch.randint(0, H, (q, 3), generator=generator, device=device)
            u = torch.rand((q,), generator=generator, device=device)
            draws.append(GridDraws(jitter, coords, u))
    return draws


def _set_last_wins(tmp_row, indices, values):
    """tmp_row[indices] = values where, for a repeated index, the LAST
    occurrence wins (what a sequential scatter does), on any device."""
    pos = torch.arange(indices.shape[0], device=indices.device)
    last = torch.full((tmp_row.shape[0],), -1, dtype=torch.int64, device=indices.device)
    last.scatter_reduce_(0, indices, pos, reduce="amax")
    keep = last[indices] == pos
    tmp_row[indices[keep]] = values[keep]


@torch.no_grad()
def update_occupancy_grid(grid: OccupancyGrid, density_fn, *, bound,
                          grid_size=128, density_scale=1.0, density_thresh=0.01,
                          decay=0.95, full=True, draws=None, generator=None,
                          chunk=1 << 21):
    """One maintenance step: re-query densities, decayed-max EMA, live copy,
    re-threshold at ``min(mean_density, density_thresh)``.

    ``density_fn(x [M, 3]) -> [M]`` raw sigmas.  ``full`` queries every
    cell; otherwise H^3/4 random cells plus H^3/4 occupied cells resampled
    uniformly with replacement by inverse CDF.  ``draws``: one ``GridDraws``
    per cascade; drawn from ``generator`` when None.  Queries run in chunks
    of ``chunk`` points."""
    C = grid.density.shape[0]
    H = grid_size
    dev = grid.density.device
    if draws is None:
        draws = draw_grid_randomness(generator, C, H, full, dev)
    tmp = -torch.ones_like(grid.density)
    for cas in range(C):
        cas_bound = min(2**cas, bound)
        dr = draws[cas]
        if full:
            coords = _linear_coords(H, dev)
            indices = (coords[:, 0] * H + coords[:, 1]) * H + coords[:, 2]
        else:
            rand_coords = dr.rand_coords.to(device=dev, dtype=torch.int64)
            rand_idx = (rand_coords[:, 0] * H + rand_coords[:, 1]) * H + rand_coords[:, 2]
            occ_mask = (grid.density[cas] > 0).to(torch.float32)
            weights = occ_mask if bool(occ_mask.any()) else torch.ones_like(occ_mask)
            cdf = torch.cumsum(weights, dim=0)
            u = dr.occ_u.to(dev) * cdf[-1]
            occ_idx = torch.clamp(torch.searchsorted(cdf, u), 0, H**3 - 1)
            occ_coords = torch.stack(
                [occ_idx // (H * H), (occ_idx // H) % H, occ_idx % H], dim=-1)
            coords = torch.cat([rand_coords, occ_coords], dim=0)
            indices = torch.cat([rand_idx, occ_idx], dim=0)
        xyzs = _cell_world_coords(coords, cas_bound, H, dr.jitter.to(dev))
        sigmas = torch.cat([density_fn(xyzs[h:h + chunk]).reshape(-1)
                            for h in range(0, xyzs.shape[0], chunk)])
        sigmas = (sigmas * density_scale).to(tmp.dtype)
        if full:
            tmp[cas, indices] = sigmas
        else:
            _set_last_wins(tmp[cas], indices, sigmas)

    valid = (grid.density >= 0) & (tmp >= 0)
    density = torch.where(valid, torch.maximum(grid.density * decay, tmp), grid.density)
    mean_density = torch.clamp_min(density, 0.0).mean()
    live_prev = (grid.density_live if grid.density_live is not None
                 else torch.zeros_like(grid.density))
    density_live = torch.where(valid, tmp, live_prev)
    thresh = torch.clamp_max(mean_density, density_thresh)
    return OccupancyGrid(
        density=density,
        occupancy=(density > thresh).reshape(C, H, H, H),
        mean_density=mean_density,
        iter_density=grid.iter_density + 1,
        density_live=density_live,
    )


@torch.no_grad()
def mark_untrained_grid(grid: OccupancyGrid, poses, intrinsics, *, bound,
                        grid_size=128, chunk=16):
    """Mark cells seen by no training camera as -1 (never occupied).

    The JAX package's ``mark_untrained_grid`` (ref ``nerf/renderer.py:
    379-442``): per cascade, the frustum test of every cell centre against
    every camera, ``chunk`` poses at a time.  poses: cam2world [B, 4, 4]
    tensor; intrinsics: (fx, fy, cx, cy)."""
    C = grid.density.shape[0]
    H = grid_size
    dev = grid.density.device
    fx, fy, cx, cy = intrinsics
    world = 2.0 * _linear_coords(H, dev).to(torch.float32) / (H - 1) - 1.0  # [H^3, 3]
    poses = poses.to(device=dev, dtype=torch.float32)
    count = torch.zeros((C, H**3), dtype=torch.int32, device=dev)
    for cas in range(C):
        cas_bound = min(2**cas, bound)
        half = cas_bound / H
        pts = world * (cas_bound - half)
        for b in range(0, poses.shape[0], chunk):
            pose_c = poses[b:b + chunk]
            cam = torch.bmm(pts[None] - pose_c[:, None, :3, 3], pose_c[:, :3, :3])
            mz = cam[..., 2] > 0
            mx = torch.abs(cam[..., 0]) < cx / fx * cam[..., 2] + half * 2
            my = torch.abs(cam[..., 1]) < cy / fy * cam[..., 2] + half * 2
            count[cas] += (mz & mx & my).sum(dim=0, dtype=torch.int32)
    density = torch.where(count == 0, -1.0, grid.density)
    return grid._replace(density=density)


def packbits(occupancy_flat):
    """Pack a flat bool tensor (len divisible by 8) into uint8, LSB-first."""
    bits = occupancy_flat.reshape(-1, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.int64).to(torch.uint8)
