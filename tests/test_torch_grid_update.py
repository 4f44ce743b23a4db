"""K6, the occupancy-grid update (``ops/grid.py:update_occupancy_grid``).

The card's kernels (``csrc/grid.cu``) cannot run here, so their algorithm is
emulated in torch, step by step as the kernels take it, and held against the
plain version on the CPU:

* the occupied-cell resample: the ceil(u)-th cell of the occupied list
  (``k6_occupied`` + ``k6_points``) against the plain version's
  ``searchsorted`` over its cumsum, with u = 0, u just below and at the
  count, past it, one occupied cell, nothing occupied (the uniform
  fallback) and every cell -1;
* the scatter: the packed 64-bit max of ((pos + 1) << 32 | bits(value))
  (``k6_scatter``) against ``_set_last_wins``, with forced duplicates;
* the whole update, the finalize in place (``k6_finalize``), the mean over
  its clamped buffer and the threshold pass (``k6_threshold``), against the
  plain update's five tensors.

All three bit for bit: the same cells chosen and the same roundings.  The
plain version is also held against JAX's ``update_occupancy_grid`` on JAX's
own draws at the same edges: the queried cells and iter_density exactly;
density, density_live and mean_density to atol 3e-5 and rtol 1e-6 (XLA
contracts the cell position ``xyz * (b - half) + jitter * half`` into an
FMA where the port rounds both products: an ulp of position, ~1.2e-7 near
|x| = 1, which the edge cases' density 30 (1 - |x|^2), of slope up to 60,
carries into sigma at up to ~7e-6 a coordinate); occupancy exactly but on
cells within that band of the threshold.  The card
itself (the kernels against the plain route, bit for bit) is held in
``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.ops import grid as j_grid
from nerf_signature_tpu_torch.kernel_cases import k6_density, k6_edge_grids
from nerf_signature_tpu_torch.ops import grid as t_grid
from test_torch_render import _jax_draws

CASES = ("empty", "untrained", "one_cell", "edges", "random")
KW = dict(density_scale=1.0, density_thresh=10.0, decay=0.95)


def _grid(dens, live, H):
    C = dens.shape[0]
    return t_grid.OccupancyGrid(torch.from_numpy(dens.copy()),
                                torch.zeros((C, H, H, H), dtype=torch.bool),
                                torch.zeros(()), torch.tensor(3, dtype=torch.int32),
                                torch.from_numpy(live.copy()))


def _draws(raw):
    return [t_grid.GridDraws(*(None if a is None else torch.from_numpy(a) for a in d))
            for d in raw]


def _case(C, H, full, name):
    (_, dens, live, raw), = [c for c in k6_edge_grids(C, H, full) if c[0] == name]
    return _grid(dens, live, H), _draws(raw)


def emulate_occupied(density_row, occ_u, H):
    """k6_occupied's list and k6_points' resample: u = occ_u * count (one
    fp32 product; H^3 where nothing is occupied), then the ceil(u)-th
    occupied cell (the ceil(u)-th cell with nothing occupied), cell 0 for
    u <= 0, the last cell past the count."""
    H3 = H**3
    occupied = torch.nonzero(density_row > 0).reshape(-1)  # index order
    count = occupied.numel()
    total = torch.tensor(float(count if count else H3), dtype=torch.float32)
    u = occ_u * total
    out = torch.full(u.shape, H3 - 1, dtype=torch.int64)
    mid = (u > 0) & (u <= total)
    r = torch.ceil(u[mid]).to(torch.int64) - 1
    out[mid] = occupied[r] if count else r
    out[u <= 0] = 0
    return out


def emulate_scatter(n_cells, cells, values):
    """k6_scatter into zeroed words, read back as k6_finalize reads them (a
    word of 0: not queried, -1)."""
    pos = torch.arange(1, cells.numel() + 1, dtype=torch.int64)
    bits = values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    words = torch.zeros((n_cells,), dtype=torch.int64)
    words.scatter_reduce_(0, cells, (pos << 32) | bits, reduce="amax")
    low = words & 0xFFFFFFFF
    low = torch.where(low >= 2**31, low - 2**32, low).to(torch.int32).view(torch.float32)
    return torch.where(words == 0, -1.0, low)


def emulate_finalize(density, live, clamped, tmp, decay):
    """k6_finalize on one range of cells, in place, each cell's reads and
    writes together."""
    d = density.clone()
    valid = (d >= 0) & (tmp >= 0)
    nd = torch.where(valid, torch.fmax(d * decay, tmp), d)
    density.copy_(nd)
    live.copy_(torch.where(valid, tmp, live))
    clamped.copy_(torch.where(torch.isnan(nd), nd, torch.fmax(nd, torch.zeros(()))))


def emulate_update(grid, draws, bound, H, full, chunk, density_scale, density_thresh, decay):
    """The kernel route of update_occupancy_grid_, in place into ``grid``:
    per cascade the queries (their positions as the plain version computes
    them: the card's own roundings are held on the card), each chunk of
    sigmas finalized at once (full) or scattered (partial); then the
    partial update's finalize, the mean of the clamped buffer and the
    threshold pass."""
    C, H3 = grid.density.shape[0], H**3
    clamped = torch.empty_like(grid.density)
    words_tmp = -torch.ones_like(grid.density)
    occupied_rows = grid.density.clone()  # the lists are made before any write
    for cas in range(C):
        dr = draws[cas]
        if full:
            cells = torch.arange(H3)
        else:
            rc = dr.rand_coords.to(torch.int64)
            cells = torch.cat([(rc[:, 0] * H + rc[:, 1]) * H + rc[:, 2],
                               emulate_occupied(occupied_rows[cas], dr.occ_u, H)])
        coords = torch.stack([cells // (H * H), cells // H % H, cells % H], -1)
        pos = t_grid._cell_world_coords(coords, min(2**cas, bound), H, dr.jitter)
        sig = []
        for h in range(0, cells.numel(), chunk):
            s = k6_density(pos[h:h + chunk]) * density_scale
            if full:
                sl = slice(h, h + s.numel())
                emulate_finalize(grid.density[cas, sl], grid.density_live[cas, sl],
                                 clamped[cas, sl], s, decay)
            sig.append(s)
        if not full:
            words_tmp[cas] = emulate_scatter(H3, cells, torch.cat(sig))
    if not full:
        emulate_finalize(grid.density, grid.density_live, clamped, words_tmp, decay)
    torch.mean(clamped, dim=(0, 1), out=grid.mean_density)
    m = grid.mean_density
    thresh = torch.where(torch.isnan(m), m, torch.fmin(m, torch.tensor(density_thresh)))
    grid.occupancy.copy_((grid.density > thresh).reshape(grid.occupancy.shape))
    grid.iter_density.add_(1)
    return grid


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_resample_is_the_ceil_u_th_occupied_cell(C, name):
    H = 16
    grid, draws = _case(C, H, False, name)
    for cas in range(C):
        cells, _ = t_grid._plain_points(grid.density[cas], draws[cas], min(2**cas, 2.0), H, False)
        q = draws[cas].occ_u.shape[0]
        got = emulate_occupied(grid.density[cas], draws[cas].occ_u, H)
        assert torch.equal(got, cells[q:])
        if name == "edges":  # u = 0, just below and at the count: the first and last
            occupied = torch.nonzero(grid.density[cas] > 0).reshape(-1)
            assert got[:4].tolist() == [0, int(occupied[-1]), int(occupied[-1]), H**3 - 1]


@pytest.mark.parametrize("dup", ["one_cell", "few_cells", "spread"])
def test_packed_max_is_last_wins(dup):
    rng = np.random.default_rng(4)
    n_cells, n = 64, 3000
    cells = {"one_cell": np.full(n, 17), "few_cells": rng.integers(0, 3, n),
             "spread": rng.integers(0, n_cells, n)}[dup]
    values = rng.uniform(-2.0, 50.0, n).astype(np.float32)
    values[::7] = 0.0
    values[3::11] = -0.0
    cells, values = torch.from_numpy(cells).to(torch.int64), torch.from_numpy(values)
    ref = -torch.ones((n_cells,))
    t_grid._set_last_wins(ref, cells, values)
    _bits_equal(emulate_scatter(n_cells, cells, values), ref)


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_update_in_place_matches_plain(name, C, full):
    H = 16
    grid, draws = _case(C, H, full, name)
    n = H**3 if full else 2 * (H**3 // 4)
    bound = 1.0 if C == 1 else 2.0
    ref = t_grid.update_occupancy_grid(grid, k6_density, bound=bound, grid_size=H, full=full,
                                       draws=draws, chunk=n // 3 + 1, plain=True, **KW)
    mine = _grid(grid.density.numpy(), grid.density_live.numpy(), H)
    ids = [id(t) for t in mine]
    emulate_update(mine, draws, bound, H, full, n // 3 + 1, **KW)
    assert [id(t) for t in mine] == ids
    for field in t_grid.OccupancyGrid._fields:
        _bits_equal(getattr(mine, field), getattr(ref, field))


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("C", [1, 2])
def test_update_in_place_matches_plain_at_32(C, full):
    H = 32
    grid, draws = _case(C, H, full, "random")
    bound = 1.0 if C == 1 else 2.0
    ref = t_grid.update_occupancy_grid(grid, k6_density, bound=bound, grid_size=H, full=full,
                                       draws=draws, plain=True, **KW)
    mine = emulate_update(_grid(grid.density.numpy(), grid.density_live.numpy(), H), draws,
                          bound, H, full, 1 << 21, **KW)
    for field in t_grid.OccupancyGrid._fields:
        _bits_equal(getattr(mine, field), getattr(ref, field))


def test_mean_into_a_scalar_is_the_plain_mean():
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 40, (2, 4096)).astype(np.float32))
    out = torch.zeros(())
    torch.mean(x, dim=(0, 1), out=out)
    _bits_equal(out, x.mean())


def test_the_card_refuses_grids_past_2_to_the_24_cells():
    t_grid.check_kernel_grid(256)  # 2^24 cells: the most its exact cdf takes
    with pytest.raises(ValueError, match="2\\^24"):
        t_grid.check_kernel_grid(257)


def test_the_in_place_form_keeps_the_grids_tensors_on_the_cpu():
    H = 16
    grid, draws = _case(2, H, False, "random")
    ids = [t.data_ptr() for t in grid]
    ref = t_grid.update_occupancy_grid(grid, k6_density, bound=2.0, grid_size=H, full=False,
                                       draws=draws, **KW)
    out = t_grid.update_occupancy_grid_(grid, k6_density, bound=2.0, grid_size=H, full=False,
                                        draws=draws, **KW)
    assert out is grid and [t.data_ptr() for t in grid] == ids
    for field in t_grid.OccupancyGrid._fields:
        _bits_equal(getattr(grid, field), getattr(ref, field))


# ---- the plain version against JAX's update on JAX's own draws

def _j_density(x):
    return jnp.maximum(1.0 - (x * x).sum(-1), 0.0) * 30.0


@pytest.fixture(scope="module")
def jax_update():
    """JAX's update_occupancy_grid at H = 16, compiled once per (C, full)."""
    compiled = {}

    def run(grid, key, bound, full):
        fn = compiled.setdefault((bound, full), jax.jit(
            lambda g, k: j_grid.update_occupancy_grid(g, k, _j_density, bound=bound,
                                                      grid_size=16, full=full, **KW)))
        return fn(grid, key)

    return run


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("name", ["empty", "one_cell", "edges"])
def test_plain_matches_jax_on_its_draws(jax_update, name, C, full):
    H = 16
    bound = 1.0 if C == 1 else 2.0
    grid, _ = _case(C, H, full, name)
    # a live value no query gives: the cells JAX queried are the ones it changed
    grid = grid._replace(density_live=torch.full_like(grid.density, -7.0))
    key = jax.random.PRNGKey(11 + C)
    gj = j_grid.OccupancyGrid(*(jnp.asarray(t.numpy()) for t in grid))
    gj = jax_update(gj, key, bound, full)
    gt = t_grid.update_occupancy_grid(grid, k6_density, bound=bound, grid_size=H, full=full,
                                      draws=_jax_draws(key, C, H, full), plain=True, **KW)
    live_j = np.asarray(gj.density_live)
    assert np.array_equal(live_j == -7.0, gt.density_live.numpy() == -7.0)
    np.testing.assert_allclose(gt.density_live.numpy(), live_j, rtol=1e-6, atol=3e-5)
    dj = np.asarray(gj.density)
    np.testing.assert_allclose(gt.density.numpy(), dj, rtol=1e-6, atol=3e-5)
    np.testing.assert_allclose(float(gt.mean_density), float(gj.mean_density), rtol=1e-6,
                               atol=3e-5)
    thresh = min(float(gj.mean_density), KW["density_thresh"])
    near = np.abs(dj - thresh) <= 3e-5
    occ_j = np.asarray(gj.occupancy).reshape(C, -1)
    assert np.array_equal(gt.occupancy.numpy().reshape(C, -1)[~near], occ_j[~near])
    assert int(gt.iter_density) == int(gj.iter_density)
