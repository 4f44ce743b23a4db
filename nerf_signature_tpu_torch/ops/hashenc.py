"""Multiresolution hash encoding (K1): the exact 8-corner path.

Counterpart of ``nerf_signature_tpu/ops/hashenc.py``: per-level resolution
``floor(base * b**i)``, the XOR-of-primes spatial hash masked to
``2**S - 1`` (or a row-major index on dense coarse levels), 8-corner
trilinear interpolation, features concatenated level-major -> ``[M, L*F]``,
one ``[rows, F]`` table for all levels.

``hash_encode`` is the kernel wrapper, differentiable in the master table
through ``HashEncodeFn``: on a CUDA tensor it launches ``csrc/hashenc.cu``
forward and backward (or raises); on a CPU tensor it runs
``hash_encode_plain`` and ``hash_encode_bwd_plain``.  The backward is an fp32
scatter-add of the corner contributions into the master table, rounded to
bf16 first when the rows are gathered in bf16, like JAX.  No gradient flows
to the positions.  ``pitch`` asks for output rows wider than L*F, the extra
columns zero: K4 reads its features at its built input width, so on the
card an encoding width it lacks (24, 48) reaches it zero-padded, written so
by K1 itself.  The stochastic estimators (K7) and the 2D background
encoder (K8) are not ported yet.
"""

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
_U32 = 0xFFFFFFFF


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


def _corners(x, resolutions, log2_hashmap_size, shared_table, dense_sides, dtype):
    """Yield (row index [L, M] int64, trilinear weight [L, M]) per corner, in
    the JAX corner order and with its roundings."""
    L = len(resolutions)
    dev = x.device
    x = torch.clamp(x, 0.0, 1.0)
    res = torch.as_tensor(np.asarray(resolutions, np.float32), device=dev)[:, None]
    scaled = [x[:, a][None, :] * res for a in range(3)]  # [L, M]
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


def hash_encode(x, table, resolutions, log2_hashmap_size, gather_dtype=None,
                shared_table=False, dense_sides=None, table_g=None,
                stochastic_grad=False, level_stride=1, fwd_corners=8, plain=False,
                pitch=None):
    """Encode positions x in [0, 1]^3 -> [M, L*F] fp32 features (K1),
    differentiable in ``table`` (the fp32 master); on the kernels, [M, pitch]
    with the columns past L*F zero when ``pitch`` is given.

    CUDA tensors go through the kernels (forward and backward); CPU tensors,
    or ``plain=True``, through ``hash_encode_plain`` and
    ``hash_encode_bwd_plain``.  The stochastic estimators are K7, not
    ported."""
    if stochastic_grad or fwd_corners != 8 or level_stride != 1:
        raise NotImplementedError(
            "stochastic hash estimators (stochastic_grad, fwd_corners=1, "
            "level_stride) are ROADMAP queue 2 item K7, not ported yet")
    _check_addressing(shared_table, dense_sides)
    if table_g is None:
        gd = gather_dtype or table.dtype
        table_g = table.detach().to(gd) if gd != table.dtype else table.detach()
    LF = len(resolutions) * table.shape[-1]
    plain = plain or not x.is_cuda
    if pitch is not None and (pitch < LF or plain and pitch != LF):
        raise ValueError(f"pitch {pitch} with L*F = {LF}: the kernels take a pitch of at "
                         f"least L*F, the plain versions none but L*F")
    meta = (tuple(resolutions), log2_hashmap_size, shared_table, dense_sides, plain, pitch)
    return HashEncodeFn.apply(x, table, table_g, meta)


class HashEncodeFn(torch.autograd.Function):
    """K1 with its backward.  Inputs: x [M, 3], the fp32 master table (the
    gradient's target), the table in the gather dtype (no gradient), and
    (resolutions, log2 size, shared_table, dense_sides, plain, pitch)."""

    @staticmethod
    def forward(ctx, x, table, table_g, meta):
        res, log2, shared, sides, plain, pitch = meta
        ctx.save_for_backward(x)
        ctx.meta, ctx.gather_dtype = meta, table_g.dtype
        ctx.n_rows, ctx.F = table.shape
        if plain:
            return hash_encode_plain(x, table, res, log2, shared_table=shared,
                                     dense_sides=sides, table_g=table_g)
        return _hash_encode_kernel(x, table_g, table.shape[0], res, log2, shared, sides, pitch)

    @staticmethod
    def backward(ctx, g_feat):
        (x,) = ctx.saved_tensors
        res, log2, shared, sides, plain, _ = ctx.meta
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        if plain:
            g = hash_encode_bwd_plain(x, g_feat.contiguous(), ctx.n_rows, res, log2,
                                      ctx.gather_dtype, shared, sides)
        else:
            g = _hash_encode_bwd_kernel(x, g_feat.contiguous(), ctx.n_rows, res, log2,
                                        ctx.gather_dtype, shared, sides, ctx.F)
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
                        dense_sides, pitch=None):
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
    _cuda.HASH_ENCODE(
        x.data_ptr(), table_g.data_ptr(), int(table_g.dtype == torch.bfloat16), F,
        out.data_ptr(), pitch, M, L,
        res.ctypes.data_as(_cuda._FP), offs.ctypes.data_as(_cuda._UP),
        sides.ctypes.data_as(_cuda._UP), log2_hashmap_size)
    return out


def _hash_encode_bwd_kernel(x, g_feat, n_rows, resolutions, log2_hashmap_size, gather_dtype,
                            shared_table, dense_sides, n_features=None):
    """K1's backward: g_feat [M, pitch] (its first L*F columns; F =
    ``n_features``, or pitch // L) -> the table's gradient [n_rows, F]."""
    L = len(resolutions)
    M, pitch = x.shape[0], g_feat.shape[-1]
    F = _kernel_features(n_features or pitch // L, L)
    if pitch < L * F:
        raise ValueError(f"g_feat: {pitch} columns < L*F = {L * F}")
    _cuda.check(x, "x", torch.float32, (M, 3))
    _cuda.check(g_feat, "g_feat", torch.float32, (M, pitch), x.device)
    g_table = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    res, offs, sides = _level_args(L, resolutions, log2_hashmap_size, shared_table, dense_sides)
    _cuda.HASH_ENCODE_BWD(
        x.data_ptr(), g_feat.data_ptr(), pitch, int(gather_dtype == torch.bfloat16), F,
        g_table.data_ptr(), M, L,
        res.ctypes.data_as(_cuda._FP), offs.ctypes.data_as(_cuda._UP),
        sides.ctypes.data_as(_cuda._UP), log2_hashmap_size, combine_mask(resolutions))
    return g_table


def hash_encode_2d(*args, **kwargs):
    """2D background-sphere encoder: ROADMAP queue 2 item K8."""
    raise NotImplementedError(
        "hash_encode_2d (the bg-sphere model, bg_radius > 0) is ROADMAP "
        "queue 2 item K8, not ported yet")
