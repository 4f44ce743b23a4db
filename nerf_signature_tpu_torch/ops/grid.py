"""Cascaded occupancy grid: state and maintenance.

Counterpart of ``nerf_signature_tpu/ops/grid.py``.  Cells are row-major
``(x*H + y)*H + z``; occupancy is a bool ``[C, H, H, H]`` tensor.  Every
random draw of an update is an explicit input (``GridDraws``) or comes from
the ``torch.Generator`` the caller passes, so a test can hand the port the
very numbers ``jax.random`` drew.

K6, the update (``update_occupancy_grid``), has two routes.  On the card,
the work around its density queries (which stay K1 + K4, in the same
chunks) is ``csrc/grid.cu``, written into the grid's own tensors with
buffers kept once per device, C and H (``_buffers``): no copy, no other
allocation, nothing read back; a build or launch failure raises.  On CPU
tensors (or ``plain=True``) the plain PyTorch version runs.  The two agree
bit for bit on the card (the cdf the plain version searches is exact while
H^3 <= 2^24, and the card refuses larger grids).
"""

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _cuda


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
    occurrence wins (what a sequential scatter does), on any device, with
    no host sync: the earlier occurrences are written to a spare slot past
    the row's end, which is dropped."""
    n = tmp_row.shape[0]
    pos = torch.arange(indices.shape[0], device=indices.device)
    last = torch.full((n,), -1, dtype=torch.int64, device=indices.device)
    last.scatter_reduce_(0, indices, pos, reduce="amax")
    dst = torch.where(last[indices] == pos, indices, n)
    padded = torch.cat([tmp_row, tmp_row.new_zeros((1,))])
    padded[dst] = values
    tmp_row.copy_(padded[:n])


def _plain_points(density_row, dr: GridDraws, cas_bound, H, full):
    """One cascade's queries, plain version: (cells [n] int64, jittered
    world positions [n, 3])."""
    dev = density_row.device
    if full:
        coords = _linear_coords(H, dev)
        indices = (coords[:, 0] * H + coords[:, 1]) * H + coords[:, 2]
    else:
        rand_coords = dr.rand_coords.to(device=dev, dtype=torch.int64)
        rand_idx = (rand_coords[:, 0] * H + rand_coords[:, 1]) * H + rand_coords[:, 2]
        occ_mask = (density_row > 0).to(torch.float32)
        weights = torch.where(occ_mask.any(), occ_mask, torch.ones_like(occ_mask))
        cdf = torch.cumsum(weights, dim=0)
        u = dr.occ_u.to(dev) * cdf[-1]
        occ_idx = torch.clamp(torch.searchsorted(cdf, u), 0, H**3 - 1)
        occ_coords = torch.stack(
            [occ_idx // (H * H), (occ_idx // H) % H, occ_idx % H], dim=-1)
        coords = torch.cat([rand_coords, occ_coords], dim=0)
        indices = torch.cat([rand_idx, occ_idx], dim=0)
    return indices, _cell_world_coords(coords, cas_bound, H, dr.jitter.to(dev))


# the cells a tile of csrc/grid.cu's occupied-cell list takes; the most
# cells a cascade may have on the card (the plain version's fp32 cdf is
# exact up to there)
OCC_TILE = 2048
MAX_KERNEL_CELLS = 2**24


class _Buffers(NamedTuple):
    """K6's buffers on the card for one (device, C, H): the queries'
    positions [H^3, 3] and cells [H^3] (the largest update's), the occupied
    lists [C, H^3], the list's scratch (a tile counter and a status word a
    tile), the scatter's words [C, H^3] and clamp_min(density, 0) [C, H^3]."""

    pos: torch.Tensor
    cell: torch.Tensor
    occupied: torch.Tensor
    scratch: torch.Tensor
    words: torch.Tensor
    clamped: torch.Tensor


@functools.lru_cache(maxsize=4)
def _buffers(device, C, H):
    H3 = H**3
    tiles = -(-H3 // OCC_TILE)
    e = functools.partial(torch.empty, device=device)
    return _Buffers(e((H3, 3), dtype=torch.float32), e((H3,), dtype=torch.int32),
                    e((C, H3), dtype=torch.int32), e((1 + C * tiles,), dtype=torch.int64),
                    e((C, H3), dtype=torch.int64), e((C, H3), dtype=torch.float32))


def check_kernel_grid(H):
    """The card's route takes a cascade of at most 2^24 cells: past that the
    plain version's fp32 cdf is no longer exact, and the two would part."""
    if H**3 > MAX_KERNEL_CELLS:
        raise ValueError(f"the grid update's kernels take at most 2^24 cells a cascade "
                         f"(grid_size {H}: {H**3}); run it with plain=True")


def _f32(x):
    """A Python number rounded to fp32, as PyTorch's CUDA ops take a host
    scalar (the kernels get the same float)."""
    return float(np.float32(x))


def _check_kernel_inputs(grid: OccupancyGrid, draws, H, full):
    C = grid.density.shape[0]
    dev = grid.density.device
    check_kernel_grid(H)
    H3 = H**3
    f32 = torch.float32
    _cuda.check_many((grid.density, "density", f32, (C, H3)),
                     (grid.density_live, "density_live", f32, (C, H3)),
                     (grid.occupancy, "occupancy", torch.bool, (C, H, H, H)),
                     (grid.mean_density, "mean_density", f32, ()),
                     (grid.iter_density, "iter_density", torch.int32, ()), name_device=True)
    n, q = (H3, 0) if full else (2 * (H3 // 4), H3 // 4)
    if len(draws) != C:
        raise ValueError(f"draws: expected one GridDraws a cascade ({C}), got {len(draws)}")
    for dr in draws:
        _cuda.check(dr.jitter, "jitter", f32, (n, 3), dev)
        if not full:
            if dr.rand_coords.dtype not in (torch.int64, torch.int32):
                raise TypeError(f"rand_coords: expected int64 or int32, got "
                                f"{dr.rand_coords.dtype}")
            _cuda.check(dr.rand_coords, "rand_coords", dr.rand_coords.dtype, (q, 3), dev)
            _cuda.check(dr.occ_u, "occ_u", f32, (q,), dev)
    return n, q


def _kernel_points(grid: OccupancyGrid, buf: _Buffers, draws, bound, H, full, n, q):
    """Every cascade's queries on the card, one cascade at a time (a
    generator: yields cas once its positions are in buf.pos[:n] and, for a
    partial update, its cells in buf.cell[:n]); a partial update's occupied
    lists and scatter words are made first, from the grid as it is."""
    C = grid.density.shape[0]
    H3 = H**3
    tiles = -(-H3 // OCC_TILE)
    if not full:
        _cuda.GRID_OCCUPIED(grid.density.data_ptr(), H3, C, buf.scratch.data_ptr(),
                            buf.occupied.data_ptr(), buf.words.data_ptr())
    # PyTorch's CUDA true divide by a host scalar multiplies by its fp32
    # reciprocal
    inv = float(np.float32(1.0) / np.float32(H - 1))
    for cas in range(C):
        cas_bound = min(2**cas, bound)
        half = cas_bound / H
        dr = draws[cas]
        if full:
            _cuda.GRID_POINTS_FULL(n, H, 0, dr.jitter.data_ptr(), None, 0, None, None, None,
                                   inv, _f32(cas_bound - half), _f32(half), buf.pos.data_ptr(),
                                   None)
        else:
            count = buf.scratch.data_ptr() + 8 * (cas * tiles + tiles)  # its last status word
            _cuda.GRID_POINTS(n, H, q, dr.jitter.data_ptr(), dr.rand_coords.data_ptr(),
                              int(dr.rand_coords.dtype == torch.int64), dr.occ_u.data_ptr(),
                              buf.occupied[cas].data_ptr(), count, inv, _f32(cas_bound - half),
                              _f32(half), buf.pos.data_ptr(), buf.cell.data_ptr())
        yield cas


def _update_kernel(grid: OccupancyGrid, density_fn, *, bound, grid_size=128, density_scale=1.0,
                   density_thresh=0.01, decay=0.95, full=True, draws=None, generator=None,
                   chunk=1 << 21):
    """K6 on the card, in place: ``grid``'s five tensors (density_live
    included) are rewritten; returns ``grid``."""
    H = grid_size
    check_kernel_grid(H)  # before anything is drawn
    if draws is None:
        draws = draw_grid_randomness(generator, grid.density.shape[0], H, full,
                                     grid.density.device)
    n, q = _check_kernel_inputs(grid, draws, H, full)
    C, dev = grid.density.shape[0], grid.density.device
    buf = _buffers(dev, C, H)
    dscale, dec = _f32(density_scale), _f32(decay)
    for cas in _kernel_points(grid, buf, draws, bound, H, full, n, q):
        for h in range(0, n, chunk):
            m = min(chunk, n - h)
            sig = density_fn(buf.pos[h:h + m]).reshape(-1)
            _cuda.check(sig, "sigma", torch.float32, (m,), dev)
            if full:  # the queries are the cells h .. h + m - 1
                _cuda.GRID_FINALIZE_FULL(
                    grid.density[cas, h:].data_ptr(), grid.density_live[cas, h:].data_ptr(),
                    buf.clamped[cas, h:].data_ptr(), sig.data_ptr(), None, m, dscale, dec)
            else:
                _cuda.GRID_SCATTER(sig.data_ptr(), buf.cell.data_ptr(), m, h, dscale,
                                   buf.words[cas].data_ptr())
    if not full:
        _cuda.GRID_FINALIZE(grid.density.data_ptr(), grid.density_live.data_ptr(),
                            buf.clamped.data_ptr(), None, buf.words.data_ptr(), C * H**3,
                            dscale, dec)
    # the plain version's own reduction: clamp_min(density, 0).mean()
    torch.mean(buf.clamped, dim=(0, 1), out=grid.mean_density)
    threshold = _cuda.GRID_THRESHOLD_FULL if full else _cuda.GRID_THRESHOLD
    threshold(grid.density.data_ptr(), C * H**3, grid.mean_density.data_ptr(),
              _f32(density_thresh), grid.occupancy.data_ptr(), grid.iter_density.data_ptr())
    return grid


@torch.no_grad()
def query_points(grid: OccupancyGrid, draws, *, bound, grid_size=128, full=True, plain=False):
    """The queries an update of ``grid`` on ``draws`` makes, per cascade:
    [(cells [n] int64, positions [n, 3])]: the plain version's, or on the
    card (unless ``plain``) the kernels' (how the two are held against
    each other before anything downstream)."""
    H = grid_size
    if plain or not grid.density.is_cuda:
        return [_plain_points(grid.density[cas], draws[cas], min(2**cas, bound), H, full)
                for cas in range(grid.density.shape[0])]
    if grid.density_live is None:
        grid = grid._replace(density_live=torch.zeros_like(grid.density))
    n, q = _check_kernel_inputs(grid, draws, H, full)
    buf = _buffers(grid.density.device, grid.density.shape[0], H)
    out = []
    for _ in _kernel_points(grid, buf, draws, bound, H, full, n, q):
        cells = (torch.arange(n, device=grid.density.device) if full
                 else buf.cell[:n].to(torch.int64))
        out.append((cells, buf.pos[:n].clone()))
    return out


@torch.no_grad()
def update_occupancy_grid(grid: OccupancyGrid, density_fn, *, bound,
                          grid_size=128, density_scale=1.0, density_thresh=0.01,
                          decay=0.95, full=True, draws=None, generator=None,
                          chunk=1 << 21, plain=False):
    """One maintenance step: re-query densities, decayed-max EMA, live copy,
    re-threshold at ``min(mean_density, density_thresh)``; returns the new
    grid (on the card: the kernels on a copy of ``grid``).

    ``density_fn(x [M, 3]) -> [M]`` raw sigmas.  ``full`` queries every
    cell; otherwise H^3/4 random cells plus H^3/4 occupied cells resampled
    uniformly with replacement by inverse CDF.  ``draws``: one ``GridDraws``
    per cascade; drawn from ``generator`` when None.  Queries run in chunks
    of ``chunk`` points.  No step reads a value back to the host, so an
    update can run between the replays of a captured train step.  On the
    card the kernels run unless ``plain``; on CPU tensors the plain
    version."""
    if grid.density.is_cuda and not plain:  # the kernels, in place on a copy
        live = grid.density_live if grid.density_live is not None else torch.zeros_like(
            grid.density)
        new = OccupancyGrid(grid.density.clone(), torch.empty_like(grid.occupancy),
                            torch.empty_like(grid.mean_density), grid.iter_density.clone(),
                            live.clone())
        return _update_kernel(new, density_fn, bound=bound, grid_size=grid_size,
                              density_scale=density_scale, density_thresh=density_thresh,
                              decay=decay, full=full, draws=draws, generator=generator,
                              chunk=chunk)
    C = grid.density.shape[0]
    H = grid_size
    dev = grid.density.device
    if draws is None:
        draws = draw_grid_randomness(generator, C, H, full, dev)
    tmp = -torch.ones_like(grid.density)
    for cas in range(C):
        indices, xyzs = _plain_points(grid.density[cas], draws[cas], min(2**cas, bound), H, full)
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
def update_occupancy_grid_(grid: OccupancyGrid, density_fn, *, plain=False, **kwargs):
    """``update_occupancy_grid`` written into ``grid``'s own tensors, which
    a captured train step reads by address; returns ``grid``.  On the card
    the kernels write them in place; the plain version's new tensors are
    copied in."""
    if grid.density_live is None:
        raise ValueError("an in-place grid update needs the grid's density_live tensor")
    if grid.density.is_cuda and not plain:
        return _update_kernel(grid, density_fn, **kwargs)
    new = update_occupancy_grid(grid, density_fn, plain=True, **kwargs)
    for old_t, new_t in zip(grid, new):
        old_t.copy_(new_t)
    return grid


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
