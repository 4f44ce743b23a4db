"""Multiresolution hash encoding (K1): the exact 8-corner path.

Counterpart of ``nerf_signature_tpu/ops/hashenc.py``: per-level resolution
``floor(base * b**i)``, the XOR-of-primes spatial hash masked to
``2**S - 1`` (or a row-major index on dense coarse levels), 8-corner
trilinear interpolation, features concatenated level-major -> ``[M, L*F]``,
one ``[rows, F]`` table for all levels.

``hash_encode`` is the kernel wrapper: on a CUDA tensor it launches
``csrc/hashenc.cu`` (or raises); on a CPU tensor it runs
``hash_encode_plain``.  The backward (an fp32 scatter-add), the stochastic
estimators (K7) and the 2D background encoder (K8) are not ported yet.
"""

import numpy as np
import torch

from . import _cuda

_PRIMES = (1, 2654435761, 805459861)
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
    dev = x.device
    if table_g is None:
        gd = gather_dtype or table.dtype
        table_g = table.to(gd) if gd != table.dtype else table

    x = torch.clamp(x, 0.0, 1.0)
    res = torch.as_tensor(np.asarray(resolutions, np.float32), device=dev)[:, None]
    scaled = [x[:, a][None, :] * res for a in range(3)]  # [L, M]
    floor = [torch.floor(s) for s in scaled]
    w = [(s - f).to(table.dtype) for s, f in zip(scaled, floor)]
    cell = [f.to(torch.int64) for f in floor]

    offs = torch.as_tensor(
        level_offsets(L, log2_hashmap_size, shared_table, dense_sides).astype(np.int64),
        device=dev)[:, None]
    if dense_sides is not None and any(dense_sides):
        sides = torch.as_tensor(np.array(dense_sides, np.int64), device=dev)[:, None]
        dense = sides > 0
    else:
        sides = None

    acc = torch.zeros((L, M, F), dtype=table.dtype, device=dev)
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
        acc = acc + cw[..., None] * table_g[idx].to(table.dtype)
    return acc.permute(1, 0, 2).reshape(M, L * F)


def hash_encode(x, table, resolutions, log2_hashmap_size, gather_dtype=None,
                shared_table=False, dense_sides=None, table_g=None,
                stochastic_grad=False, level_stride=1, fwd_corners=8):
    """Encode positions x in [0, 1]^3 -> [M, L*F] fp32 features (K1).

    CUDA tensors go through the kernel; CPU tensors through
    ``hash_encode_plain``.  The stochastic estimators are K7, not ported."""
    if stochastic_grad or fwd_corners != 8 or level_stride != 1:
        raise NotImplementedError(
            "stochastic hash estimators (stochastic_grad, fwd_corners=1, "
            "level_stride) are ROADMAP queue 2 item K7, not ported yet")
    if not x.is_cuda:
        return hash_encode_plain(x, table, resolutions, log2_hashmap_size,
                                 gather_dtype, shared_table, dense_sides, table_g)
    _check_addressing(shared_table, dense_sides)
    _cuda.no_grad_inputs("hash_encode", x, table)
    L = len(resolutions)
    F = table.shape[-1]
    if F != 2:
        raise ValueError(f"the hash-encode kernel gathers F = 2 feature rows, got F = {F}")
    if table_g is None:
        gd = gather_dtype or table.dtype
        table_g = table.to(gd) if gd != table.dtype else table
    if table_g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gather dtype must be bfloat16 or float32, got {table_g.dtype}")
    M = x.shape[0]
    _cuda.check(x, "x", torch.float32, (M, 3))
    _cuda.check(table_g, "table_g", table_g.dtype, (table.shape[0], 2), x.device)
    out = torch.empty((M, L * F), dtype=torch.float32, device=x.device)
    res = np.ascontiguousarray(np.asarray(resolutions, np.float32))
    offs = np.ascontiguousarray(level_offsets(L, log2_hashmap_size, shared_table, dense_sides))
    sides = np.ascontiguousarray(np.array(
        dense_sides if dense_sides is not None else [0] * L, np.uint32))
    _cuda.HASH_ENCODE(
        x.data_ptr(), table_g.data_ptr(), int(table_g.dtype == torch.bfloat16),
        out.data_ptr(), M, L,
        res.ctypes.data_as(_cuda._FP), offs.ctypes.data_as(_cuda._UP),
        sides.ctypes.data_as(_cuda._UP), log2_hashmap_size)
    return out


def hash_encode_2d(*args, **kwargs):
    """2D background-sphere encoder: ROADMAP queue 2 item K8."""
    raise NotImplementedError(
        "hash_encode_2d (the bg-sphere model, bg_radius > 0) is ROADMAP "
        "queue 2 item K8, not ported yet")
