"""K10: the CopyRNeRF baseline's per-sample MLP input (counterpart of the
concatenation in ``nerf_signature_tpu/models/copyrnerf.py:copyrnerf_color``
and the ``x01`` of ``models/watermark.py:wtmk_field``).

``copyrnerf_input(x, d, rgb, raw, message, bound)`` is, per sample,
``[freq_encode(2 x01 - 1, 10), freq_encode(d, 4), rgb, raw, 2 m - 1]``
with ``x01 = (x + bound) / (2 bound)``: [M, 88 + D] fp32.  On a CUDA tensor
it launches ``csrc/copyrnerf.cu`` (or raises); on a CPU tensor it runs
``copyrnerf_input_plain``, the same operations in PyTorch (a broadcast,
multiply, ``sin``, ``cos``, ``cat``).  Forward only: nothing upstream of
the input takes a gradient.
"""

import functools

import numpy as np
import torch

from . import _cuda

N_FREQS_POS = 10
N_FREQS_DIR = 4
N_FIXED = 3 * 2 * N_FREQS_POS + 3 * 2 * N_FREQS_DIR + 4  # 88


@functools.lru_cache(maxsize=None)
def _freqs(n_freqs, device):
    """fp32(2^k) * fp32(pi), k < n_freqs, on ``device``, copied there once (a
    copy from the host cannot run inside a captured step)."""
    f = (2.0 ** np.arange(n_freqs)).astype(np.float32) * np.float32(np.pi)
    return torch.as_tensor(f, device=device)


def freq_encode(x, n_freqs):
    """[..., C] -> [..., C * 2 * n_freqs]: the sines of ``x_c * 2^k pi``
    (channel-major, fp32 frequencies), then the cosines in the same order,
    as JAX lays them out."""
    C = x.shape[-1]
    ang = (x[..., :, None] * _freqs(n_freqs, x.device)).reshape(*x.shape[:-1], C * n_freqs)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def copyrnerf_input_from01(x01, d, rgb, raw, message):
    """The MLP input from the scaled position ``x01`` in [0, 1] (JAX's
    ``copyrnerf_color`` arguments): [M, 88 + D] fp32."""
    n = x01.shape[0]
    msg = (2.0 * message.to(torch.float32) - 1.0)[None, :].expand(n, message.shape[0])
    return torch.cat([freq_encode(2.0 * x01 - 1.0, N_FREQS_POS), freq_encode(d, N_FREQS_DIR),
                      rgb.to(torch.float32), raw.to(torch.float32)[:, None], msg], dim=-1)


def copyrnerf_input_plain(x, d, rgb, raw, message, bound):
    """Plain version of K10."""
    b = torch.full((), bound, dtype=torch.float32, device=x.device)
    return copyrnerf_input_from01((x + b) / (2.0 * b), d, rgb, raw, message)


def copyrnerf_input(x, d, rgb, raw, message, bound):
    """x, d, rgb [M, 3] fp32, raw [M] fp32 (the density logit), message [D]
    int32 0/1 on the same device -> [M, 88 + D] fp32."""
    if not x.is_cuda:
        return copyrnerf_input_plain(x, d, rgb, raw, message, bound)
    M, D = x.shape[0], message.shape[0]
    dev = x.device
    for t, name in ((x, "x"), (d, "d"), (rgb, "rgb")):
        _cuda.check(t, name, torch.float32, (M, 3), dev)
    _cuda.check(raw, "raw", torch.float32, (M,), dev)
    _cuda.check(message, "message", torch.int32, (D,), dev)
    out = torch.empty((M, N_FIXED + D), dtype=torch.float32, device=dev)
    _cuda.COPYRNERF_INPUT(x.data_ptr(), d.data_ptr(), rgb.data_ptr(), raw.data_ptr(),
                          message.data_ptr(), D, float(bound), out.data_ptr(), M)
    return out
