"""P1: a scalar gather from a single-level table (counterpart of the Pallas
probe ``scripts_dev/pallas_gather_probe.py:pallas_gather``, the repo's only
``pl.pallas_call``).

``table_gather(table, idx)`` is ``out[j] = table[idx[j]]`` for a [T] fp32
table and [N] int32 indices in [0, T).  On a CUDA tensor it launches
``csrc/gather.cu`` (or raises); on a CPU tensor it runs ``table_gather_plain``.
No entry point calls it: the probe's idea, a gather from one message-table
level, runs on the watermark path as K9 + K1.
"""

import torch

from . import _cuda


def table_gather_plain(table, idx):
    """Plain version: ``table[idx]``."""
    return table[idx.long()]


def table_gather(table, idx, out=None):
    """[T] fp32 table, [N] int32 indices -> [N] fp32, written into ``out``
    when it is given (any 1-D contiguous view: the kernel takes unaligned
    starts and any N in one launch)."""
    if not table.is_cuda:
        res = table_gather_plain(table, idx)
        return res if out is None else out.copy_(res)
    T, N = table.shape[0], idx.shape[0]
    _cuda.check(table, "table", torch.float32, (T,))
    _cuda.check(idx, "idx", torch.int32, (N,), table.device)
    if out is None:
        out = torch.empty((N,), dtype=torch.float32, device=table.device)
    else:
        _cuda.check(out, "out", torch.float32, (N,), table.device)
    _cuda.TABLE_GATHER(table.data_ptr(), idx.data_ptr(), T, N, out.data_ptr())
    return out
