"""Codebook message tables (counterpart of
``nerf_signature_tpu/models/message.py``).

``2 * message_dim`` tables ``[D, 2, T, F]``, all at one resolution; bit i
picks table ``[i, m_i]`` and the picked tables are summed into ONE effective
table ``[T, F]`` (interpolation is linear in the table, so the sum commutes
with the hash gather), which one single-level hash encode then reads.

The effective table is K9 (``csrc/msgtable.cu``), differentiable in the
tables through ``MsgTableFn``: its forward sums the selected tables in bit
order and writes the gather-dtype copy K1 reads in the same pass; its
backward writes ``g_eff`` into each selected table and zeros into the
others.  On a CPU tensor both run their plain versions.
"""

import numpy as np
import torch

from ..ops import _cuda
from ..ops.hashenc import _uniform, hash_encode


def init_msg_tables(generator, message_dim, n_features=2, log2_hashmap_size=19,
                    device="cpu"):
    """[message_dim, 2, 2**S, F] fp32, U(-1e-4, 1e-4) like the reference."""
    return _uniform(generator, (message_dim, 2, 1 << log2_hashmap_size, n_features), device)


def _bits(message, device):
    """The message as an int32 tensor of 0/1 on ``device`` (nonzero is 1)."""
    m = torch.as_tensor(np.asarray(message) if not torch.is_tensor(message) else message,
                        device=device)
    return (m.reshape(-1) != 0).to(torch.int32).contiguous()


def msg_table_plain(tables, bits, gather_dtype=torch.float32):
    """Plain version of the K9 forward: (eff [T, F] fp32, eff in the gather
    dtype), the selected tables added one bit at a time in bit order."""
    D = tables.shape[0]
    sel = bits.long()
    eff = tables[0, sel[0]].clone()
    for i in range(1, D):
        eff = eff + tables[i, sel[i]]
    return eff, eff.detach().to(gather_dtype, copy=True)


def msg_table_bwd_plain(g_eff, bits, D):
    """Plain version of the K9 backward: g_tables [D, 2, T, F], g_eff in the
    selected table of every bit and zeros in the other."""
    T, F = g_eff.shape
    g = torch.zeros((D * 2, T, F), dtype=torch.float32, device=g_eff.device)
    rows = torch.arange(D, device=g_eff.device) * 2 + bits.long()
    g.index_copy_(0, rows, g_eff.expand(D, T, F).contiguous())
    return g.reshape(D, 2, T, F)


def _msg_table_kernel(tables, bits, gather_dtype):
    D, _, T, F = tables.shape
    dev = tables.device
    _cuda.check(tables, "tables", torch.float32, (D, 2, T, F))
    _cuda.check(bits, "message", torch.int32, (D,), dev)
    if gather_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gather dtype must be bfloat16 or float32, got {gather_dtype}")
    eff = torch.empty((T, F), dtype=torch.float32, device=dev)
    eff_g = torch.empty((T, F), dtype=gather_dtype, device=dev)
    _cuda.MSG_TABLE(tables.data_ptr(), bits.data_ptr(), D, T * F, eff.data_ptr(),
                    eff_g.data_ptr(), int(gather_dtype == torch.bfloat16))
    return eff, eff_g


def _msg_table_bwd_kernel(g_eff, bits, D):
    T, F = g_eff.shape
    dev = g_eff.device
    _cuda.check(g_eff, "g_eff", torch.float32, (T, F))
    _cuda.check(bits, "message", torch.int32, (D,), dev)
    g = torch.empty((D, 2, T, F), dtype=torch.float32, device=dev)
    _cuda.MSG_TABLE_BWD(g_eff.data_ptr(), bits.data_ptr(), D, T * F, g.data_ptr())
    return g


class MsgTableFn(torch.autograd.Function):
    """K9 forward and backward: (tables [D, 2, T, F], bits [D] int32, gather
    dtype, plain) -> (eff [T, F] fp32, eff_g [T, F] in the gather dtype, no
    gradient)."""

    @staticmethod
    def forward(ctx, tables, bits, gather_dtype, plain):
        ctx.save_for_backward(bits)
        ctx.D, ctx.plain = tables.shape[0], plain
        if plain:
            eff, eff_g = msg_table_plain(tables.detach(), bits, gather_dtype)
        else:
            eff, eff_g = _msg_table_kernel(tables, bits, gather_dtype)
        ctx.mark_non_differentiable(eff_g)
        return eff, eff_g

    @staticmethod
    def backward(ctx, g_eff, _g_eff_g):
        (bits,) = ctx.saved_tensors
        g_eff = g_eff.contiguous()
        if ctx.plain:
            return msg_table_bwd_plain(g_eff, bits, ctx.D), None, None, None
        return _msg_table_bwd_kernel(g_eff, bits, ctx.D), None, None, None


def effective_table(tables, message, gather_dtype=torch.float32, plain=False):
    """(eff [T, F] fp32, differentiable in ``tables``; eff_g, the same table
    in ``gather_dtype`` for K1's gather).  CUDA tables go through K9 unless
    ``plain``; CPU tables through the plain versions."""
    bits = _bits(message, tables.device)
    if bits.shape[0] != tables.shape[0]:
        raise ValueError(f"message has {bits.shape[0]} bits, the tables {tables.shape[0]}")
    return MsgTableFn.apply(tables, bits, gather_dtype, plain or not tables.is_cuda)


def msg_effective_table(tables, message, plain=False):
    """Collapse the codebook for one message: [D, 2, T, F] -> [T, F] fp32."""
    return effective_table(tables, message, plain=plain)[0]


def msg_encode(tables, message, x01, *, resolution=2048, log2_hashmap_size=19):
    """x01: [N, 3] in [0, 1] -> [N, F] summed per-bit features (fp32)."""
    eff, eff_g = effective_table(tables, message)
    return hash_encode(x01, eff, np.array([float(resolution)]), log2_hashmap_size,
                       table_g=eff_g)
