"""K5: global sample compaction (counterpart of the compaction inside
``nerf_signature_tpu/render/renderer.py:render_rays_occ``).

A train step's march gives [N, S] sample slots, most of them empty; the
field runs on Mc static slots holding the occupied samples instead.  Over
the flat M = N * S samples, ``rank`` is the exclusive prefix count of the
mask and ``keep = mask & (rank < Mc)``: the kept samples fill slots
0 .. min(count, Mc) - 1 in sample order, the rest of the slots hold zeros.
One rank of a data-parallel group packs its shard with ``cap``, an int64
device scalar (``parallel/mesh.py:compaction_cap``): ``keep = mask & (rank
< cap)``, cap clamped to [0, Mc], Mc then the size of its slot buffer.

``compact`` packs (no gradient: positions and directions carry none into
the field) and ``uncompact`` scatters the field's (sigma [Mc], rgb [Mc, 3])
back to [M] and [M, 3], zero where a sample was not kept.  On CUDA tensors
they launch ``csrc/compact.cu`` (``uncompact`` under autograd through
``UncompactFn``, whose backward is the gather through the inverse slot map,
``K5_compact_unpack_bwd``, tiled as the unpack is) or raise; on CPU tensors
(or ``plain=True``) they run ``compact_plain`` / ``uncompact_plain``, the JAX formula, whose
backward is autograd's ``indexing_backward`` of ``sig_c[clamp(rank)]``.
Kernel and plain version agree bit for bit, forward and backward: every
value is a copy.
"""

from typing import NamedTuple

import torch

from . import _cuda

# samples a block of the pack takes (csrc/compact.cu:PACK_TILE); its scratch
# holds a tile counter and one status word a tile
PACK_TILE = 2048


class Compaction(NamedTuple):
    """The packed samples and the maps between samples and slots.  Plain
    version: ``keep`` [M] bool and ``rank`` [M] int64; kernel: ``slot_of``
    [M] int32 (the slot, -1 where not kept) and ``sample_of`` [Mc] int32
    (the sample, -1 for an empty slot)."""

    xyz_c: torch.Tensor
    dir_c: torch.Tensor
    Mc: int
    keep: torch.Tensor = None
    rank: torch.Tensor = None
    slot_of: torch.Tensor = None
    sample_of: torch.Tensor = None


def compact_plain(mask, xyzs, rays_d, Mc, cap=None):
    """Plain version of the pack: mask [N, S] bool, xyzs [N, S, 3], rays_d
    [N, 3], cap None or an int64 scalar tensor -> ``Compaction`` with xyz_c,
    dir_c [Mc, 3], keep and rank."""
    N, S = mask.shape
    dirs = rays_d[:, None, :].expand(N, S, 3)
    flat_mask = mask.reshape(-1)
    rank = torch.cumsum(flat_mask.to(torch.int64), dim=0) - 1
    limit = Mc if cap is None else torch.clamp(cap, 0, Mc)
    keep = flat_mask & (rank < limit)
    dst = torch.where(keep, rank, Mc)
    xyz_c = torch.zeros((Mc + 1, 3), dtype=xyzs.dtype, device=xyzs.device)
    xyz_c[dst] = xyzs.reshape(-1, 3)
    dir_c = torch.zeros((Mc + 1, 3), dtype=rays_d.dtype, device=xyzs.device)
    dir_c[dst] = dirs.reshape(-1, 3)
    return Compaction(xyz_c[:Mc].contiguous(), dir_c[:Mc].contiguous(), Mc, keep=keep, rank=rank)


def uncompact_plain(sig_c, rgb_c, comp: Compaction):
    """Plain version of the unpack: (sigmas [M], rgbs [M, 3]), differentiable
    in sig_c and rgb_c (autograd's indexing_backward)."""
    src = torch.clamp(comp.rank, 0, comp.Mc - 1)
    sigmas = torch.where(comp.keep, sig_c[src], 0.0)
    rgbs = torch.where(comp.keep[:, None], rgb_c[src], 0.0)
    return sigmas, rgbs


def slot_maps_plain(comp: Compaction):
    """The kernel's (slot_of [M], sample_of [Mc]) int32 maps from the plain
    version's keep and rank."""
    dev = comp.keep.device
    slot_of = torch.where(comp.keep, comp.rank, -1).to(torch.int32)
    # the kept samples' slots are distinct; every other sample lands on the
    # spare slot Mc, dropped
    sample_of = torch.full((comp.Mc + 1,), -1, dtype=torch.int32, device=dev)
    sample_of[torch.where(comp.keep, comp.rank, comp.Mc)] = torch.arange(
        comp.keep.shape[0], dtype=torch.int32, device=dev)
    return slot_of, sample_of[:comp.Mc]


def compact(mask, xyzs, rays_d, Mc, plain=False, cap=None):
    """K5 pack: mask [N, S] bool, xyzs [N, S, 3] fp32 (zero where masked),
    rays_d [N, 3] fp32, 0 <= Mc, cap None or an int64 scalar on the device
    -> ``Compaction``."""
    if plain or not mask.is_cuda:
        return compact_plain(mask, xyzs, rays_d, Mc, cap)
    N, S = mask.shape
    M = N * S
    dev = mask.device
    if M >= 2**31 or Mc >= 2**31:
        raise ValueError(f"K5 takes fewer than 2^31 samples and slots (M={M}, Mc={Mc})")
    _cuda.check(mask, "mask", torch.bool, (N, S), dev)
    _cuda.check(xyzs, "xyzs", torch.float32, (N, S, 3), dev)
    _cuda.check(rays_d, "rays_d", torch.float32, (N, 3), dev)
    if cap is not None:
        _cuda.check(cap, "cap", torch.int64, (), dev)
    f32, i32 = torch.float32, torch.int32
    scratch = torch.empty((-(-M // PACK_TILE) + 1,), dtype=torch.int64, device=dev)
    xyz_c = torch.empty((Mc, 3), dtype=f32, device=dev)
    dir_c = torch.empty((Mc, 3), dtype=f32, device=dev)
    slot_of = torch.empty((M,), dtype=i32, device=dev)
    sample_of = torch.empty((Mc,), dtype=i32, device=dev)
    _cuda.COMPACT_PACK(mask.data_ptr(), xyzs.data_ptr(), rays_d.data_ptr(), M, S, Mc,
                       _cuda.ptr(cap), scratch.data_ptr(), xyz_c.data_ptr(), dir_c.data_ptr(),
                       slot_of.data_ptr(), sample_of.data_ptr())
    return Compaction(xyz_c, dir_c, Mc, slot_of=slot_of, sample_of=sample_of)


def _sig_rgb(n, device):
    """Uninitialised fp32 ([n], [n, 3]): contiguous views of one allocation,
    the rows of 3 from the first 16-byte boundary past the n singles (one
    allocation a call; the kernels store both as 16-byte spans)."""
    at = -(-n // 4) * 4
    buf = torch.empty((at + 3 * n,), dtype=torch.float32, device=device)
    return buf.as_strided((n,), (1,)), buf.as_strided((n, 3), (3, 1), at)


def _unpack_kernel(sig_c, rgb_c, slot_of):
    """K5 unpack on the card: (sigmas [M], rgbs [M, 3]), contiguous views of
    one allocation (rgbs from the first 16-byte boundary past the sigmas)."""
    M, Mc = slot_of.shape[0], sig_c.shape[0]
    _cuda.check_many((sig_c, "sig_c", torch.float32, (Mc,)),
                     (rgb_c, "rgb_c", torch.float32, (Mc, 3)),
                     (slot_of, "slot_of", torch.int32, (M,)), name_device=True)
    sig, rgb = _sig_rgb(M, sig_c.device)
    _cuda.COMPACT_UNPACK(sig_c.data_ptr(), rgb_c.data_ptr(), slot_of.data_ptr(), M,
                         sig.data_ptr(), rgb.data_ptr())
    return sig, rgb


def unpack_bwd(g_sig, g_rgb, sample_of):
    """K5 unpack backward on the card: (g_sig_c [Mc], g_rgb_c [Mc, 3]),
    views of one allocation (``_sig_rgb``)."""
    M, Mc, dev = g_sig.shape[0], sample_of.shape[0], g_sig.device
    _cuda.check(g_sig, "g_sigmas", torch.float32, (M,), dev)
    _cuda.check(g_rgb, "g_rgbs", torch.float32, (M, 3), dev)
    _cuda.check(sample_of, "sample_of", torch.int32, (Mc,), dev)
    g_sig_c, g_rgb_c = _sig_rgb(Mc, dev)
    _cuda.COMPACT_UNPACK_BWD(g_sig.data_ptr(), g_rgb.data_ptr(), sample_of.data_ptr(), Mc,
                             g_sig_c.data_ptr(), g_rgb_c.data_ptr())
    return g_sig_c, g_rgb_c


class UncompactFn(torch.autograd.Function):
    """K5 unpack and its backward (the gather through ``sample_of``)."""

    @staticmethod
    def forward(ctx, sig_c, rgb_c, slot_of, sample_of):
        ctx.save_for_backward(sample_of)
        ctx.M = slot_of.shape[0]
        return _unpack_kernel(sig_c, rgb_c, slot_of)

    @staticmethod
    def backward(ctx, g_sig, g_rgb):
        (sample_of,) = ctx.saved_tensors
        dev = sample_of.device
        if g_sig is None:
            g_sig = torch.zeros((ctx.M,), dtype=torch.float32, device=dev)
        if g_rgb is None:
            g_rgb = torch.zeros((ctx.M, 3), dtype=torch.float32, device=dev)
        g_sig_c, g_rgb_c = unpack_bwd(g_sig.contiguous(), g_rgb.contiguous(), sample_of)
        return g_sig_c, g_rgb_c, None, None


def uncompact(sig_c, rgb_c, comp: Compaction):
    """K5 unpack: (sig_c [Mc], rgb_c [Mc, 3]) -> (sigmas [M], rgbs [M, 3]),
    zero where a sample was not kept; differentiable in sig_c and rgb_c."""
    if comp.slot_of is None:
        return uncompact_plain(sig_c, rgb_c, comp)
    if _cuda.needs_grad(sig_c, rgb_c):
        return UncompactFn.apply(sig_c, rgb_c, comp.slot_of, comp.sample_of)
    return _unpack_kernel(sig_c, rgb_c, comp.slot_of)
