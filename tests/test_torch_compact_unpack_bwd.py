"""K5's unpack backward (``csrc/compact.cu:k5_unpack_bwd``, the body
``gather_tile`` it shares with the unpack) emulated tile by tile in plain
PyTorch and held against ``tests/test_torch_compact.py:unpack_bwd_gather``
and JAX's gradient of the compaction's gather (``sig_c[src]``,
``rgb_c[src]`` in ``nerf_signature_tpu/render/renderer.py:render_rays_occ``)
on the CPU.

The CUDA kernel cannot run here, so this file pins its tiling: a block takes
UNPACK_TILE = 1024 consecutive slots, stages their ``sample_of`` entries
(one int4 a thread where the tile is whole and the map aligned, scalars
else, -1 past the end), gathers each slot's cotangents (a warp's lanes on
consecutive slots; zeros for an empty slot) into shared memory, and writes
the tile's spans of g_sig_c and g_rgb_c.  Every value is a copy, so the
limit is bit-equality, against both.  Inputs: ragged Mc (not a multiple
of the tile nor of 4), empty slots at the tail (Mc above the kept count),
kept counts ending at a tile's edge and one either side of it, a single
slot, and the kernel-case edges of ``kernel_cases.k5_edge_inputs``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu_torch import kernel_cases
from nerf_signature_tpu_torch.ops import _cuda
from nerf_signature_tpu_torch.ops import compact as t_compact
from test_torch_compact import unpack_bwd_gather
from test_torch_train_ops import rel_l2  # noqa: F401  (one torch thread a module)

T = torch.from_numpy
THREADS, UNPACK_ITEMS = 256, 4
UNPACK_TILE = THREADS * UNPACK_ITEMS


def emulate_unpack_bwd(g_sig, g_rgb, sample_of):
    """The kernel's tiles: (g_sig_c [Mc], g_rgb_c [Mc, 3], tiles run); each
    output element written exactly once (checked)."""
    Mc = sample_of.shape[0]
    g_sig_c = torch.full((Mc,), float("nan"))
    g_rgb_c = torch.full((Mc, 3), float("nan"))
    written = torch.zeros(4 * Mc, dtype=torch.int64)
    tiles = -(-Mc // UNPACK_TILE)
    for b in range(tiles):
        m0 = b * UNPACK_TILE
        n = min(UNPACK_TILE, Mc - m0)
        # the staged map, one int4 (or 4 scalars) a thread, -1 past the end
        smap = torch.full((UNPACK_TILE,), -1, dtype=torch.int64)
        smap[:n] = sample_of[m0:m0 + n].long()
        # thread t, item k takes slot t + THREADS k: consecutive slots a warp
        j = (torch.arange(THREADS)[:, None] + THREADS * torch.arange(UNPACK_ITEMS)[None]).reshape(-1)
        s = smap[j]
        live = s >= 0
        src = s.clamp(min=0)
        osig = torch.zeros(UNPACK_TILE)
        orgb = torch.zeros((UNPACK_TILE, 3))
        osig[j] = torch.where(live, g_sig[src], 0.0)
        orgb[j] = torch.where(live[:, None], g_rgb[src], 0.0)
        # the spans [m0, m0 + n) and [3 m0, 3 (m0 + n))
        g_sig_c[m0:m0 + n] = osig[:n]
        g_rgb_c[m0:m0 + n] = orgb[:n]
        written[m0:m0 + n] += 1
        written[Mc + 3 * m0:Mc + 3 * (m0 + n)] += 1
    assert bool((written == 1).all())
    return g_sig_c, g_rgb_c, tiles


def _jax_gather_grad(mask, Mc, g_sig, g_rgb):
    """JAX's gradient of the compaction's gather at the slots: the VJP of
    (where(keep, sig_c[src], 0), where(keep, rgb_c[src], 0)), written as
    render_rays_occ writes it."""
    flat = jnp.asarray(mask.reshape(-1))
    rank = jnp.cumsum(flat.astype(jnp.int32)) - 1
    keep = flat & (rank < Mc)
    src = jnp.clip(rank, 0, Mc - 1)

    def gather(sig_c, rgb_c):
        return (jnp.where(keep, sig_c[src], jnp.zeros((), sig_c.dtype)),
                jnp.where(keep[:, None], rgb_c[src], jnp.zeros((), rgb_c.dtype)))

    _, vjp = jax.vjp(gather, jnp.zeros((Mc,), jnp.float32), jnp.zeros((Mc, 3), jnp.float32))
    gs, gr = vjp((jnp.asarray(g_sig), jnp.asarray(g_rgb)))
    return np.asarray(gs), np.asarray(gr)


def _prefix_mask(N, S, kept, seed):
    """Rays whose samples are a prefix of their S slots (as K2 writes them),
    ``kept`` samples set in all."""
    rng = np.random.default_rng(seed)
    n = np.zeros(N, np.int64)
    for _ in range(kept):
        r = rng.integers(0, N)
        while n[r] == S:
            r = rng.integers(0, N)
        n[r] += 1
    return np.arange(S)[None, :] < n[:, None]


# name -> (N, S, samples set, Mc): the kept count ends mid-tile with a long
# empty tail; at a tile's edge and one either side of it; Mc ragged (not a
# multiple of 4) and above the count; Mc below the count (samples dropped,
# no empty slot); a single slot
CASES = {"ragged_tail": (64, 100, 2500, 4099),
         "edge": (40, 128, 2 * UNPACK_TILE, 3 * UNPACK_TILE),
         "edge_minus_one": (40, 128, 2 * UNPACK_TILE - 1, 2 * UNPACK_TILE + 3),
         "edge_plus_one": (40, 128, 2 * UNPACK_TILE + 1, 2 * UNPACK_TILE + 1),
         "dropped": (30, 200, 5000, 3 * UNPACK_TILE - 5),
         "one_slot": (3, 50, 20, 1)}


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_unpack_bwd_matches_the_gather_and_jax(name):
    N, S, kept, Mc = CASES[name]
    mask = _prefix_mask(N, S, kept, seed=Mc)
    rng = np.random.default_rng(N * S)
    xyzs = np.where(mask[..., None], rng.uniform(-1, 1, (N, S, 3)), 0.0).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    g_sig = rng.normal(size=(N * S,)).astype(np.float32)
    g_rgb = rng.normal(size=(N * S, 3)).astype(np.float32)
    comp = t_compact.compact_plain(T(mask), T(xyzs), T(rd), Mc)
    _, sample_of = t_compact.slot_maps_plain(comp)
    n_kept = min(kept, Mc)
    assert int((sample_of >= 0).sum()) == n_kept and bool((sample_of[n_kept:] == -1).all())
    ge_s, ge_r, tiles = emulate_unpack_bwd(T(g_sig), T(g_rgb), sample_of)
    assert tiles == -(-Mc // UNPACK_TILE)
    want_s, want_r = unpack_bwd_gather(T(g_sig), T(g_rgb), sample_of)
    assert torch.equal(ge_s, want_s) and torch.equal(ge_r, want_r)
    js, jr = _jax_gather_grad(mask, Mc, g_sig, g_rgb)
    assert np.array_equal(ge_s.numpy(), js) and np.array_equal(ge_r.numpy(), jr)
    assert not bool(ge_s[n_kept:].any()) and not bool(ge_r[n_kept:].any())


@pytest.mark.parametrize("name", [c[0] for c in kernel_cases.k5_edge_inputs()])
def test_emulated_unpack_bwd_on_the_kernel_cases(name):
    """The K5 edge cases (every mask off, Mc = M, a single live sample at the
    last index, N = 0, many tiles, ...): the emulation equals the gather."""
    case = {c[0]: c for c in kernel_cases.k5_edge_inputs()}[name]
    mask, xyzs, rd, Mc, _, _, g_sig, g_rgb = case[1:]
    comp = t_compact.compact_plain(T(mask), T(xyzs), T(rd), Mc)
    _, sample_of = t_compact.slot_maps_plain(comp)
    ge_s, ge_r, _ = emulate_unpack_bwd(T(g_sig), T(g_rgb), sample_of)
    want_s, want_r = unpack_bwd_gather(T(g_sig), T(g_rgb), sample_of)
    assert torch.equal(ge_s, want_s) and torch.equal(ge_r, want_r)


def test_tile_constants_are_the_kernels():
    """The emulation's tile is ``csrc/compact.cu``'s: THREADS and
    UNPACK_ITEMS as the source defines them."""
    with open(f"{_cuda.CSRC}/compact.cu") as f:
        src = f.read()
    const = dict(re.findall(r"constexpr int (THREADS|UNPACK_ITEMS) = (\d+);", src))
    assert (int(const["THREADS"]), int(const["UNPACK_ITEMS"])) == (THREADS, UNPACK_ITEMS)
