"""Multiresolution hash encoding: K1 (the exact 8-corner path), K7 (the
stochastic estimators) and K8 (the background sphere's 2D encoding).

Counterpart of ``nerf_signature_tpu/ops/hashenc.py``: per-level resolution
``floor(base * b**i)``, the XOR-of-primes spatial hash masked to
``2**S - 1`` (or a row-major index on dense coarse levels), 8-corner
trilinear interpolation, features concatenated level-major -> ``[M, L*F]``,
one ``[rows, F]`` table for all levels.

``hash_encode`` is the kernel wrapper, differentiable in the master table
through ``HashEncodeFn``: on a CUDA tensor it launches the kernels forward
and backward (or raises); on a CPU tensor it runs their plain versions.
K1's backward is an fp32 scatter-add of the corner contributions into the
master table, rounded to bf16 first when the rows are gathered in bf16,
like JAX.  No gradient flows to the positions.  ``pitch`` asks for output
rows wider than L*F, the extra columns zero: K4 reads its features at its
built input width, so on the card an encoding width it lacks (24, 48)
reaches it zero-padded, written so by the kernel itself.

K7 (``stochastic_grad``, ``level_stride``, ``fwd_corners=1``;
``csrc/hashenc_stoch.cu``): one corner per (level, sample), drawn with
probability equal to its weight from the sample's own position bits
(``stochastic_choice``).  The backward scatters the fp32 cotangent itself
into that corner's row (unbiased, one add instead of eight, never rounded
to bf16), at a stride of levels when ``level_stride`` divides L; the
forward stays K1's exact one, or with ``fwd_corners=1`` is the chosen row.

K8 (``hash_encode_2d``, ``bg_encode``; ``csrc/hashenc_bg.cu``): 4-corner
bilinear interpolation with the 2D hash, every level hashed, of the exit
point of a ray on the background sphere (``ops/intersect.py:sph_from_ray``),
computed inside the kernels from the rays.
"""

import math

import numpy as np
import torch

from . import _cuda

_PRIMES = (1, 2654435761, 805459861)
# the row widths (features a row) and level counts the kernels take
# (csrc/hashenc.cu: NGP_MAX_LEVELS); anything else runs only through the
# plain versions
KERNEL_FEATURES = (1, 2, 4, 8)
KERNEL_MAX_LEVELS = 32
# K1's backward groups a warp's adds into one row (__match_any_sync, one
# atomic a group) at the levels of at most this resolution, where the
# samples of a ray share corner rows (32 samples a march step apart span
# ~14 cells at 256); at finer levels the groups are mostly single lanes and
# the match is not run.  On an H100 at the clean step's shape
# (scripts_port/kernel_ab.py) the limits 0, 128, 256, 512 and 2^20 read
# 1.31, 0.95, 0.97, 1 and 1.08 times the device time at 512
COMBINE_MAX_RES = 256
_CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]
_CORNERS_2D = [(i, j) for i in (0, 1) for j in (0, 1)]
_U32 = 0xFFFFFFFF
# K7: the salt of the level-stride phase's hash and its remixing multiplier
_PHASE_SALT = 0x9E3779B9
_PHASE_MUL = 2654435761
# K7's choice audit: a (level, sample) whose u lies within this of one of
# its running corner sums may be chosen differently where that sum is
# contracted into FMAs (XLA on the CPU; ROADMAP queue 3)
CHOICE_MARGIN = 2.0 ** -22


def level_resolutions(n_levels, base_resolution, finest_resolution):
    """Per-level grid resolutions (float64 numpy, like the JAX package)."""
    if n_levels == 1:
        return np.array([float(base_resolution)])
    b = np.exp(
        (np.log(float(finest_resolution)) - np.log(float(base_resolution)))
        / (n_levels - 1)
    )
    return np.floor(base_resolution * b ** np.arange(n_levels)).astype(np.float64)


def init_hash_table(generator, n_levels, n_features, log2_hashmap_size,
                    device="cpu"):
    """``[n_levels * 2**S, F]`` fp32, U(-1e-4, 1e-4)."""
    size = n_levels * (1 << log2_hashmap_size)
    return _uniform(generator, (size, n_features), device)


def level_sides(resolutions, log2_hashmap_size, dense_coarse):
    """Per-level dense grid side (res + 2), or 0 where the level is hashed."""
    sides = []
    for r in resolutions:
        side = int(r) + 2
        sides.append(side if (dense_coarse and side**3 <= (1 << log2_hashmap_size))
                     else 0)
    return tuple(sides)


def level_row_counts(sides, log2_hashmap_size):
    """Rows per level: side**3 for dense levels, 2**S for hashed ones."""
    return np.array(
        [s**3 if s else (1 << log2_hashmap_size) for s in sides], np.int64
    )


def init_hash_table_sized(generator, sides, n_features, log2_hashmap_size,
                          device="cpu"):
    """``[sum(level_row_counts), F]`` fp32, U(-1e-4, 1e-4)."""
    size = int(level_row_counts(sides, log2_hashmap_size).sum())
    return _uniform(generator, (size, n_features), device)


def _uniform(generator, shape, device):
    t = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (t * 2e-4 - 1e-4).to(device)


def _hash3(cx, cy, cz, log2_hashmap_size):
    """The uint32 spatial hash, computed in int64: each product is masked to
    32 bits (the uint32 wrap) before the XOR and the table mask."""
    h = (cx * _PRIMES[0]) & _U32
    h = h ^ ((cy * _PRIMES[1]) & _U32)
    h = h ^ ((cz * _PRIMES[2]) & _U32)
    return h & ((1 << log2_hashmap_size) - 1)


def _mul_u32(a, b):
    """(a * b) mod 2**32 of int64 tensors holding uint32 values, without
    int64 overflow: a split into 16-bit halves."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _float_bits(t):
    """The uint32 bit patterns of an fp32 tensor, as int64."""
    return t.contiguous().view(torch.int32).to(torch.int64) & _U32


def _hash24(a, b, c):
    """24 bits of the XOR-of-primes hash of three uint32 words (int64)."""
    h = a ^ _mul_u32(b, _PRIMES[1]) ^ _mul_u32(c, _PRIMES[2])
    return h & ((1 << 24) - 1)


def level_offsets(L, log2_hashmap_size, shared_table=False, dense_sides=None):
    """First table row of each level (numpy uint32 [L])."""
    if shared_table:
        return np.zeros(L, np.uint32)
    if dense_sides is not None and any(dense_sides):
        counts = level_row_counts(dense_sides, log2_hashmap_size)
        return np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.uint32)
    return (np.arange(L, dtype=np.uint32) << np.uint32(log2_hashmap_size))


def _check_addressing(shared_table, dense_sides):
    if shared_table and dense_sides is not None:
        raise ValueError("shared_table and dense_sides are mutually "
                         "exclusive addressing schemes")


def hash_encode_plain(x, table, resolutions, log2_hashmap_size,
                      gather_dtype=None, shared_table=False, dense_sides=None,
                      table_g=None):
    """Plain PyTorch version of the K1 forward.

    x: [M, 3] in [0, 1]; table: [rows, F] fp32 master; resolutions: [L]
    numpy.  ``gather_dtype`` (a torch dtype) is the type the rows are
    gathered in; ``table_g`` is the table already cast to it (the caller
    casts once per render).  Accumulates in the table dtype, like JAX."""
    _check_addressing(shared_table, dense_sides)
    L = len(resolutions)
    F = table.shape[-1]
    M = x.shape[0]
    if table_g is None:
        gd = gather_dtype or table.dtype
        table_g = table.to(gd) if gd != table.dtype else table
    acc = torch.zeros((L, M, F), dtype=table.dtype, device=x.device)
    for idx, cw in _corners(x, resolutions, log2_hashmap_size, shared_table,
                            dense_sides, table.dtype):
        acc = acc + cw[..., None] * table_g[idx].to(table.dtype)
    return acc.permute(1, 0, 2).reshape(M, L * F)


def _scaled(x, resolutions):
    """The clipped positions times each level's resolution, one rounding:
    a list over x's axes of [L, M] fp32."""
    x = torch.clamp(x, 0.0, 1.0)
    res = torch.as_tensor(np.asarray(resolutions, np.float32), device=x.device)[:, None]
    return [x[:, a][None, :] * res for a in range(x.shape[1])]


def _corners(x, resolutions, log2_hashmap_size, shared_table, dense_sides, dtype):
    """Yield (row index [L, M] int64, trilinear weight [L, M]) per corner, in
    the JAX corner order and with its roundings."""
    L = len(resolutions)
    dev = x.device
    scaled = _scaled(x, resolutions)
    floor = [torch.floor(s) for s in scaled]
    w = [(s - f).to(dtype) for s, f in zip(scaled, floor)]
    cell = [f.to(torch.int64) for f in floor]
    offs = torch.as_tensor(
        level_offsets(L, log2_hashmap_size, shared_table, dense_sides).astype(np.int64),
        device=dev)[:, None]
    if dense_sides is not None and any(dense_sides):
        sides = torch.as_tensor(np.array(dense_sides, np.int64), device=dev)[:, None]
        dense = sides > 0
    else:
        sides = None
    for (di, dj, dk) in _CORNERS:
        cx, cy, cz = cell[0] + di, cell[1] + dj, cell[2] + dk
        idx = _hash3(cx, cy, cz, log2_hashmap_size)
        if sides is not None:
            idx_dense = ((cx * sides + cy) * sides + cz) & _U32
            idx = torch.where(dense, idx_dense, idx)
        idx = (idx + offs) & _U32
        cw = ((w[0] if di else 1.0 - w[0])
              * (w[1] if dj else 1.0 - w[1])
              * (w[2] if dk else 1.0 - w[2]))
        yield idx, cw


def hash_encode_bwd_plain(x, g_feat, n_rows, resolutions, log2_hashmap_size,
                          gather_dtype=torch.float32, shared_table=False,
                          dense_sides=None):
    """Plain PyTorch version of the K1 backward: the fp32 master table's
    gradient [n_rows, F] from the feature cotangent g_feat [M, L*F].

    Per corner the contribution ``cw * g`` is rounded to ``gather_dtype``
    and back (the cotangent of JAX's bf16 row gather), then scatter-added
    per feature with ``index_add_``."""
    _check_addressing(shared_table, dense_sides)
    L = len(resolutions)
    M = x.shape[0]
    F = g_feat.shape[-1] // L
    g = g_feat.reshape(M, L, F).permute(1, 0, 2)  # [L, M, F]
    grad = torch.zeros(n_rows * F, dtype=torch.float32, device=x.device)
    for idx, cw in _corners(x, resolutions, log2_hashmap_size, shared_table,
                            dense_sides, torch.float32):
        ct = cw[..., None] * g
        if gather_dtype != torch.float32:
            ct = ct.to(gather_dtype).to(torch.float32)
        for f in range(F):
            grad.index_add_(0, (idx * F + f).reshape(-1), ct[..., f].reshape(-1))
    return grad.reshape(n_rows, F)


def stochastic_choice(x, resolutions, log2_hashmap_size, shared_table=False,
                      dense_sides=None, audit=False):
    """K7's corner choice (the stochastic branch of JAX's
    ``_hash_encode_impl``): per (level, sample) the row of corner c drawn
    with probability cw_c.  u = 24 bits of the XOR-of-primes hash of the
    scaled position's fp32 bit patterns, times 2^-24; the first corner (JAX
    order) whose running fp32 weight sum exceeds u, else corner 7.  Returns
    (rows [L, M] int64, phase_bits [M] int64: the salted hash of the last
    level's scaled position that ``level_keep`` reads), and with ``audit``
    also a [L, M] bool of the choices at the FMA margin (u within
    CHOICE_MARGIN of a running sum)."""
    bits = [_float_bits(s) for s in _scaled(x, resolutions)]
    u = _hash24(*bits).to(torch.float32) * (1.0 / (1 << 24))
    cum = torch.zeros_like(u)
    rows = torch.zeros(u.shape, dtype=torch.int64, device=x.device)
    done = torch.zeros(u.shape, dtype=torch.bool, device=x.device)
    margin = torch.zeros_like(done)
    for idx, cw in _corners(x, resolutions, log2_hashmap_size, shared_table, dense_sides,
                            torch.float32):
        cum = cum + cw
        newly = (u < cum) & ~done
        rows = torch.where(newly, idx, rows)
        done = done | newly
        if audit:
            margin |= (u.double() - cum.double()).abs() <= CHOICE_MARGIN
    rows = torch.where(done, rows, idx)  # corner 7 where the sum fell short of u
    phase_bits = _hash24(bits[0][-1] ^ _PHASE_SALT, bits[1][-1], bits[2][-1])
    return (rows, phase_bits, margin) if audit else (rows, phase_bits)


def effective_stride(L, level_stride):
    """The level stride K7's backward runs: ``level_stride`` where it
    divides L, else 1 (JAX's ``eff_stride``)."""
    return level_stride if L % max(level_stride, 1) == 0 else 1


def level_keep(phase_bits, L, stride):
    """[L, M] bool: the levels each sample scatters at this (effective)
    stride, l % stride == ((phase_bits * 2654435761) mod 2^32 >> 13) % stride."""
    phase = ((phase_bits * _PHASE_MUL) & _U32) >> 13
    levels = torch.arange(L, device=phase_bits.device)[:, None]
    return levels % stride == phase[None] % stride


def hash_encode_1c_plain(x, table, resolutions, log2_hashmap_size, gather_dtype=None,
                         shared_table=False, dense_sides=None, table_g=None):
    """Plain version of K7's one-corner forward (``fwd_corners=1``): per
    (level, sample) the chosen corner's row, ``1 * table_g[row]`` in the
    table's dtype -> [M, L*F]."""
    _check_addressing(shared_table, dense_sides)
    L, F, M = len(resolutions), table.shape[-1], x.shape[0]
    if table_g is None:
        gd = gather_dtype or table.dtype
        table_g = table.to(gd) if gd != table.dtype else table
    rows, _ = stochastic_choice(x, resolutions, log2_hashmap_size, shared_table, dense_sides)
    return table_g[rows].to(table.dtype).permute(1, 0, 2).reshape(M, L * F)


def hash_encode_stoch_bwd_plain(x, g_feat, n_rows, resolutions, log2_hashmap_size,
                                level_stride=1, shared_table=False, dense_sides=None):
    """Plain version of K7's backward: the fp32 master table's gradient
    [n_rows, F] from g_feat [M, L*F], each (level, sample)'s cotangent added
    whole to its chosen row (no weight, no bf16 rounding), with an effective
    stride s > 1 only at the levels ``level_keep`` gives, times s."""
    _check_addressing(shared_table, dense_sides)
    L, M = len(resolutions), x.shape[0]
    F = g_feat.shape[-1] // L
    g = g_feat.reshape(M, L, F).permute(1, 0, 2).to(torch.float32)  # [L, M, F]
    rows, phase_bits = stochastic_choice(x, resolutions, log2_hashmap_size, shared_table,
                                         dense_sides)
    stride = effective_stride(L, level_stride)
    if stride > 1:
        keep = level_keep(phase_bits, L, stride)
        g = torch.where(keep[..., None], g * float(stride), torch.zeros((), device=g.device))
    grad = torch.zeros(n_rows * F, dtype=torch.float32, device=x.device)
    for f in range(F):
        grad.index_add_(0, (rows * F + f).reshape(-1), g[..., f].reshape(-1))
    return grad.reshape(n_rows, F)


def hash_encode(x, table, resolutions, log2_hashmap_size, gather_dtype=None,
                shared_table=False, dense_sides=None, table_g=None,
                stochastic_grad=False, level_stride=1, fwd_corners=8, plain=False,
                pitch=None):
    """Encode positions x in [0, 1]^3 -> [M, L*F] fp32 features,
    differentiable in ``table`` (the fp32 master); on the kernels, [M, pitch]
    with the columns past L*F zero when ``pitch`` is given.

    The exact 8-corner path is K1; ``stochastic_grad`` keeps K1's forward
    (or, with ``fwd_corners=1``, gathers only the chosen corner's row) and
    takes K7's one-corner backward, at ``level_stride`` (where it divides
    L).  CUDA tensors go through the kernels (forward and backward); CPU
    tensors, or ``plain=True``, through their plain versions."""
    if fwd_corners not in (1, 8):
        raise ValueError("fwd_corners must be 1 or 8")
    if fwd_corners == 1 and not stochastic_grad:
        raise ValueError("fwd_corners=1 requires stochastic_grad=True (the weight-sampled "
                         "corner choice lives on that path)")
    _check_addressing(shared_table, dense_sides)
    if table_g is None:
        gd = gather_dtype or table.dtype
        table_g = table.detach().to(gd) if gd != table.dtype else table.detach()
    LF = len(resolutions) * table.shape[-1]
    plain = plain or not x.is_cuda
    if pitch is not None and (pitch < LF or plain and pitch != LF):
        raise ValueError(f"pitch {pitch} with L*F = {LF}: the kernels take a pitch of at "
                         f"least L*F, the plain versions none but L*F")
    stoch = (level_stride, fwd_corners) if stochastic_grad else None
    meta = (tuple(resolutions), log2_hashmap_size, shared_table, dense_sides, plain, pitch, stoch)
    return HashEncodeFn.apply(x, table, table_g, meta)


class HashEncodeFn(torch.autograd.Function):
    """K1 (or K7) with its backward.  Inputs: x [M, 3], the fp32 master
    table (the gradient's target), the table in the gather dtype (no
    gradient), and (resolutions, log2 size, shared_table, dense_sides,
    plain, pitch, stoch): stoch is None (exact, K1) or K7's (level_stride,
    fwd_corners)."""

    @staticmethod
    def forward(ctx, x, table, table_g, meta):
        res, log2, shared, sides, plain, pitch, stoch = meta
        ctx.save_for_backward(x)
        ctx.meta, ctx.gather_dtype = meta, table_g.dtype
        ctx.n_rows, ctx.F = table.shape
        one = stoch is not None and stoch[1] == 1
        if plain:
            fwd = hash_encode_1c_plain if one else hash_encode_plain
            return fwd(x, table, res, log2, shared_table=shared, dense_sides=sides,
                       table_g=table_g)
        fwd = _hash_encode_1c_kernel if one else _hash_encode_kernel
        return fwd(x, table_g, table.shape[0], res, log2, shared, sides, pitch)

    @staticmethod
    def backward(ctx, g_feat):
        (x,) = ctx.saved_tensors
        res, log2, shared, sides, plain, _, stoch = ctx.meta
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        g_feat = g_feat.contiguous()
        if stoch is not None:
            stride = effective_stride(len(res), stoch[0])
            if plain:
                g = hash_encode_stoch_bwd_plain(x, g_feat, ctx.n_rows, res, log2, stride,
                                                shared, sides)
            else:
                g = _hash_encode_stoch_bwd_kernel(x, g_feat, ctx.n_rows, res, log2, shared,
                                                  sides, ctx.F, stride)
        elif plain:
            g = hash_encode_bwd_plain(x, g_feat, ctx.n_rows, res, log2, ctx.gather_dtype,
                                      shared, sides)
        else:
            g = _hash_encode_bwd_kernel(x, g_feat, ctx.n_rows, res, log2, ctx.gather_dtype,
                                        shared, sides, ctx.F)
        return None, g, None, None


def _level_args(L, resolutions, log2_hashmap_size, shared_table, dense_sides):
    res = np.ascontiguousarray(np.asarray(resolutions, np.float32))
    offs = np.ascontiguousarray(level_offsets(L, log2_hashmap_size, shared_table, dense_sides))
    sides = np.ascontiguousarray(np.array(
        dense_sides if dense_sides is not None else [0] * L, np.uint32))
    return res, offs, sides


def combine_mask(resolutions):
    """The levels whose adds K1's backward groups by row: bit l set where
    level l's resolution is at most COMBINE_MAX_RES."""
    return sum(1 << lv for lv, r in enumerate(resolutions) if r <= COMBINE_MAX_RES)


def _kernel_features(F, L):
    """The row widths and level counts K1's kernels take: F in
    KERNEL_FEATURES, 1 to KERNEL_MAX_LEVELS levels."""
    if F not in KERNEL_FEATURES:
        raise ValueError(f"the hash-encode kernels take rows of F in {KERNEL_FEATURES} "
                         f"features, got F = {F}")
    if not 1 <= L <= KERNEL_MAX_LEVELS:
        raise ValueError(f"the hash-encode kernels take 1 to {KERNEL_MAX_LEVELS} levels, "
                         f"got L = {L}")
    return F


def _hash_encode_kernel(x, table_g, n_rows, resolutions, log2_hashmap_size, shared_table,
                        dense_sides, pitch=None, kernel="HASH_ENCODE"):
    """K1's forward (or, ``kernel="HASH_ENCODE_1C"``, K7's one-corner
    forward: the same arguments) -> [M, pitch] fp32."""
    L = len(resolutions)
    F = _kernel_features(table_g.shape[-1], L)
    if table_g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gather dtype must be bfloat16 or float32, got {table_g.dtype}")
    pitch = L * F if pitch is None else pitch
    if pitch < L * F:
        raise ValueError(f"pitch {pitch} < L*F = {L * F}")
    M = x.shape[0]
    _cuda.check(x, "x", torch.float32, (M, 3))
    _cuda.check(table_g, "table_g", table_g.dtype, (n_rows, F), x.device)
    out = torch.empty((M, pitch), dtype=torch.float32, device=x.device)
    res, offs, sides = _level_args(L, resolutions, log2_hashmap_size, shared_table, dense_sides)
    getattr(_cuda, kernel)(
        x.data_ptr(), table_g.data_ptr(), int(table_g.dtype == torch.bfloat16), F,
        out.data_ptr(), pitch, M, L,
        res.ctypes.data_as(_cuda._FP), offs.ctypes.data_as(_cuda._UP),
        sides.ctypes.data_as(_cuda._UP), log2_hashmap_size)
    return out


def _hash_encode_1c_kernel(x, table_g, n_rows, resolutions, log2_hashmap_size, shared_table,
                           dense_sides, pitch=None):
    """K7's one-corner forward (``csrc/hashenc_stoch.cu:hash_fwd_1c``)."""
    return _hash_encode_kernel(x, table_g, n_rows, resolutions, log2_hashmap_size,
                               shared_table, dense_sides, pitch, kernel="HASH_ENCODE_1C")


def _bwd_args(x, g_feat, n_rows, resolutions, n_features):
    """(L, M, pitch, F, a zeroed [n_rows, F] gradient) of a backward kernel's
    call, its inputs checked."""
    L = len(resolutions)
    M, pitch = x.shape[0], g_feat.shape[-1]
    F = _kernel_features(n_features or pitch // L, L)
    if pitch < L * F:
        raise ValueError(f"g_feat: {pitch} columns < L*F = {L * F}")
    _cuda.check(x, "x", torch.float32, (M, 3))
    _cuda.check(g_feat, "g_feat", torch.float32, (M, pitch), x.device)
    g_table = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    return L, M, pitch, F, g_table


def _hash_encode_bwd_kernel(x, g_feat, n_rows, resolutions, log2_hashmap_size, gather_dtype,
                            shared_table, dense_sides, n_features=None):
    """K1's backward: g_feat [M, pitch] (its first L*F columns; F =
    ``n_features``, or pitch // L) -> the table's gradient [n_rows, F]."""
    L, M, pitch, F, g_table = _bwd_args(x, g_feat, n_rows, resolutions, n_features)
    res, offs, sides = _level_args(L, resolutions, log2_hashmap_size, shared_table, dense_sides)
    _cuda.HASH_ENCODE_BWD(
        x.data_ptr(), g_feat.data_ptr(), pitch, int(gather_dtype == torch.bfloat16), F,
        g_table.data_ptr(), M, L,
        res.ctypes.data_as(_cuda._FP), offs.ctypes.data_as(_cuda._UP),
        sides.ctypes.data_as(_cuda._UP), log2_hashmap_size, combine_mask(resolutions))
    return g_table


def _hash_encode_stoch_bwd_kernel(x, g_feat, n_rows, resolutions, log2_hashmap_size,
                                  shared_table, dense_sides, n_features=None, stride=1):
    """K7's backward (``csrc/hashenc_stoch.cu:hash_bwd_stoch``): g_feat [M,
    pitch] -> the table's gradient [n_rows, F], one unrounded add per kept
    (level, sample) at the effective ``stride``."""
    L, M, pitch, F, g_table = _bwd_args(x, g_feat, n_rows, resolutions, n_features)
    if stride < 1 or L % stride:
        raise ValueError(f"level stride {stride} does not divide L = {L}")
    res, offs, sides = _level_args(L, resolutions, log2_hashmap_size, shared_table, dense_sides)
    _cuda.HASH_ENCODE_BWD_STOCH(
        x.data_ptr(), g_feat.data_ptr(), pitch, F, g_table.data_ptr(), M, L,
        res.ctypes.data_as(_cuda._FP), offs.ctypes.data_as(_cuda._UP),
        sides.ctypes.data_as(_cuda._UP), log2_hashmap_size, combine_mask(resolutions), stride)
    return g_table


# ---------------------------------------------------------------------------
# K8: the 2D encoding of the background sphere (input (theta, phi) in [0, 1]^2)
# ---------------------------------------------------------------------------


def _hash2(cx, cy, log2_hashmap_size):
    h = (cx * _PRIMES[0]) & _U32
    h = h ^ ((cy * _PRIMES[1]) & _U32)
    return h & ((1 << log2_hashmap_size) - 1)


def _corners_2d(x, resolutions, log2_hashmap_size, dtype):
    """Yield (row index [L, M] int64, bilinear weight [L, M]) per corner of
    the 2D encoding (every level hashed, level l's rows at l << log2), in the
    JAX corner order and with its roundings."""
    scaled = _scaled(x, resolutions)
    floor = [torch.floor(v) for v in scaled]
    w = [(v - f).to(dtype) for v, f in zip(scaled, floor)]
    cell = [f.to(torch.int64) for f in floor]
    offs = (torch.arange(len(resolutions), device=x.device) << log2_hashmap_size)[:, None]
    for (di, dj) in _CORNERS_2D:
        idx = _hash2(cell[0] + di, cell[1] + dj, log2_hashmap_size) + offs
        yield idx, (w[0] if di else 1.0 - w[0]) * (w[1] if dj else 1.0 - w[1])


def hash_encode_2d_plain(x, table, resolutions, log2_hashmap_size, gather_dtype=None,
                         table_g=None):
    """Plain version of K8's forward on 2D positions x [M, 2] in [0, 1]^2
    (JAX's ``hash_encode_2d``) -> [M, L*F] in the table's dtype."""
    L, F, M = len(resolutions), table.shape[-1], x.shape[0]
    if table_g is None:
        gd = gather_dtype or table.dtype
        table_g = table.to(gd) if gd != table.dtype else table
    acc = torch.zeros((L, M, F), dtype=table.dtype, device=x.device)
    for idx, cw in _corners_2d(x, resolutions, log2_hashmap_size, table.dtype):
        acc = acc + cw[..., None] * table_g[idx].to(table.dtype)
    return acc.permute(1, 0, 2).reshape(M, L * F)


def hash_encode_2d_bwd_plain(x, g_feat, n_rows, resolutions, log2_hashmap_size,
                             gather_dtype=torch.float32):
    """Plain version of K8's backward: the fp32 master table's gradient
    [n_rows, F], each corner's ``cw * g`` rounded to ``gather_dtype`` and
    back (JAX's row gather's cotangent, as in K1), then scatter-added."""
    L, M = len(resolutions), x.shape[0]
    F = g_feat.shape[-1] // L
    g = g_feat.reshape(M, L, F).permute(1, 0, 2)
    grad = torch.zeros(n_rows * F, dtype=torch.float32, device=x.device)
    for idx, cw in _corners_2d(x, resolutions, log2_hashmap_size, torch.float32):
        ct = cw[..., None] * g
        if gather_dtype != torch.float32:
            ct = ct.to(gather_dtype).to(torch.float32)
        for f in range(F):
            grad.index_add_(0, (idx * F + f).reshape(-1), ct[..., f].reshape(-1))
    return grad.reshape(n_rows, F)


def sphere_x01(rays_o, rays_d, radius):
    """The 2D encoder's input of the background sphere: (sph_from_ray + 1) / 2
    (plain; K8's kernels compute it themselves)."""
    from .intersect import sph_from_ray

    return (sph_from_ray(rays_o, rays_d, radius) + 1.0) * 0.5


def sphere_cut(rays_o, rays_d, radius, eps=1e-6):
    """[N] bool: the rays whose exit point on the sphere lies within ``eps``
    (in phi / pi) of phi's branch cut at +-pi, computed in float64 from the
    fp32 rays.  There phi may come out +1 in one implementation of atan2
    and -1 in another, so the 2D position jumps across the map; tests and
    the card's checks leave these rays out and count them."""
    o, d = rays_o.double(), rays_d.double()
    a = (d * d).sum(-1)
    b = 2.0 * (o * d).sum(-1)
    c = (o * o).sum(-1) - float(radius) ** 2
    t = (-b + torch.sqrt(torch.clamp_min(b * b - 4 * a * c, 0.0))) / (2 * a)
    p = o + t[..., None] * d
    return 1.0 - torch.atan2(p[..., 1], p[..., 0]).abs() / math.pi <= eps


def hash_encode_2d(x, table, resolutions, log2_hashmap_size, gather_dtype=None, table_g=None,
                   plain=False):
    """Encode 2D positions x [M, 2] in [0, 1]^2 -> [M, L*F] fp32 features
    (K8), differentiable in ``table`` (the fp32 master)."""
    return _encode_2d((x, None, None, 0.0), table, resolutions, log2_hashmap_size,
                      gather_dtype, table_g, plain or not x.is_cuda)


def bg_encode(rays_o, rays_d, radius, table, resolutions, log2_hashmap_size,
              gather_dtype=None, table_g=None, plain=False):
    """K8 on rays: the 2D encoding of each ray's exit point on the sphere of
    ``radius`` -> [N, L*F] fp32, differentiable in ``table``.  On the card
    the kernels compute the sphere point from the rays (no [N, 2] tensor);
    the plain path is ``sphere_x01`` then ``hash_encode_2d_plain``."""
    return _encode_2d((None, rays_o, rays_d, float(radius)), table, resolutions,
                      log2_hashmap_size, gather_dtype, table_g, plain or not rays_o.is_cuda)


def _encode_2d(inputs, table, resolutions, log2_hashmap_size, gather_dtype, table_g, plain):
    if table_g is None:
        gd = gather_dtype or table.dtype
        table_g = table.detach().to(gd) if gd != table.dtype else table.detach()
    x, rays_o, rays_d, radius = inputs
    meta = (tuple(resolutions), log2_hashmap_size, radius, plain)
    return HashEncode2dFn.apply(x, rays_o, rays_d, table, table_g, meta)


class HashEncode2dFn(torch.autograd.Function):
    """K8 with its backward.  Inputs: x [M, 2] (or None), rays_o and rays_d
    [M, 3] (or None: x given), the fp32 master table, the table in the
    gather dtype, and (resolutions, log2 size, radius, plain)."""

    @staticmethod
    def forward(ctx, x, rays_o, rays_d, table, table_g, meta):
        res, log2, radius, plain = meta
        ctx.save_for_backward(x, rays_o, rays_d)
        ctx.meta, ctx.gather_dtype = meta, table_g.dtype
        ctx.n_rows, ctx.F = table.shape
        if plain:
            if x is None:
                x = sphere_x01(rays_o, rays_d, radius)
            return hash_encode_2d_plain(x, table, res, log2, table_g=table_g)
        return _hash_encode_2d_kernel(x, rays_o, rays_d, radius, table_g, res, log2)

    @staticmethod
    def backward(ctx, g_feat):
        x, rays_o, rays_d = ctx.saved_tensors
        res, log2, radius, plain = ctx.meta
        if not ctx.needs_input_grad[3]:
            return None, None, None, None, None, None
        g_feat = g_feat.contiguous()
        if plain:
            if x is None:
                x = sphere_x01(rays_o, rays_d, radius)
            g = hash_encode_2d_bwd_plain(x, g_feat, ctx.n_rows, res, log2, ctx.gather_dtype)
        else:
            g = _hash_encode_2d_bwd_kernel(x, rays_o, rays_d, radius, g_feat, ctx.n_rows, res,
                                           log2, ctx.gather_dtype, ctx.F)
        return None, None, None, g, None, None


def _bg_inputs(x, rays_o, rays_d):
    """(N, the device, the pointers of x or of the rays) of a K8 call, its
    inputs checked."""
    if x is not None:
        N = x.shape[0]
        _cuda.check(x, "x", torch.float32, (N, 2))
        return N, x.device, (x.data_ptr(), None, None)
    N = rays_o.shape[0]
    _cuda.check(rays_o, "rays_o", torch.float32, (N, 3))
    _cuda.check(rays_d, "rays_d", torch.float32, (N, 3), rays_o.device)
    return N, rays_o.device, (None, rays_o.data_ptr(), rays_d.data_ptr())


def _hash_encode_2d_kernel(x, rays_o, rays_d, radius, table_g, resolutions, log2_hashmap_size):
    """K8's forward (``csrc/hashenc_bg.cu:hash2d_fwd``) -> [N, L*F] fp32."""
    L = len(resolutions)
    F = _kernel_features(table_g.shape[-1], L)
    if table_g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gather dtype must be bfloat16 or float32, got {table_g.dtype}")
    N, dev, ptrs = _bg_inputs(x, rays_o, rays_d)
    _cuda.check(table_g, "table_g", table_g.dtype, (L << log2_hashmap_size, F), dev)
    out = torch.empty((N, L * F), dtype=torch.float32, device=dev)
    res = np.ascontiguousarray(np.asarray(resolutions, np.float32))
    _cuda.HASH_ENCODE_2D(*ptrs, float(np.float32(radius * radius)), table_g.data_ptr(),
                         int(table_g.dtype == torch.bfloat16), F, out.data_ptr(), N, L,
                         res.ctypes.data_as(_cuda._FP), log2_hashmap_size)
    return out


def _hash_encode_2d_bwd_kernel(x, rays_o, rays_d, radius, g_feat, n_rows, resolutions,
                               log2_hashmap_size, gather_dtype, n_features):
    """K8's backward (``csrc/hashenc_bg.cu:hash2d_bwd``): g_feat [N, L*F] ->
    the table's gradient [n_rows, F]."""
    L = len(resolutions)
    F = _kernel_features(n_features, L)
    N, dev, ptrs = _bg_inputs(x, rays_o, rays_d)
    _cuda.check(g_feat, "g_feat", torch.float32, (N, L * F), dev)
    g_table = torch.zeros((n_rows, F), dtype=torch.float32, device=dev)
    res = np.ascontiguousarray(np.asarray(resolutions, np.float32))
    _cuda.HASH_ENCODE_2D_BWD(*ptrs, float(np.float32(radius * radius)), g_feat.data_ptr(),
                             int(gather_dtype == torch.bfloat16), F, g_table.data_ptr(), N, L,
                             res.ctypes.data_as(_cuda._FP), log2_hashmap_size,
                             combine_mask(resolutions))
    return g_table
