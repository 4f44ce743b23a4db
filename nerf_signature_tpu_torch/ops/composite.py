"""Front-to-back compositing with early termination (K3).

Counterpart of ``nerf_signature_tpu/ops/composite.py``: with
``tau = sigma * dt``, the transmittance entering sample i is
``T_in = exp(-(cumsum(tau) - tau))`` (inclusive cumsum, then minus tau,
exactly as the JAX formula writes it) and the weight is
``(1 - exp(-tau)) * T_in``, zero where ``T_in < T_thresh`` or masked.

``composite_rays`` is the kernel wrapper (``csrc/composite.cu`` on CUDA
tensors, ``composite_rays_plain`` on CPU ones).  The analytic backward comes
with the training slice.
"""

import torch

from . import _cuda


def composite_rays_plain(sigmas, rgbs, deltas, ts, mask=None, T_thresh=1e-4):
    """sigmas, deltas, ts: [N, S]; rgbs [N, S, 3]; mask [N, S] bool or None.
    Returns dict(weights_sum [N], depth [N], image [N, 3], weights [N, S])."""
    tau = sigmas * deltas
    if mask is not None:
        tau = torch.where(mask, tau, 0.0)
    cum = torch.cumsum(tau, dim=-1)
    T_in = torch.exp(-(cum - tau))
    alpha = 1.0 - torch.exp(-tau)
    weights = alpha * T_in
    weights = torch.where(T_in >= T_thresh, weights, 0.0)
    if mask is not None:
        weights = torch.where(mask, weights, 0.0)
    return {
        "weights_sum": weights.sum(dim=-1),
        "depth": (weights * ts).sum(dim=-1),
        "image": (weights[..., None] * rgbs).sum(dim=-2),
        "weights": weights,
    }


def composite_rays(sigmas, rgbs, deltas, ts, mask=None, T_thresh=1e-4):
    """K3 wrapper; same arguments and outputs as ``composite_rays_plain``."""
    if not sigmas.is_cuda:
        return composite_rays_plain(sigmas, rgbs, deltas, ts, mask, T_thresh)
    _cuda.no_grad_inputs("composite_rays", sigmas, rgbs, deltas, ts)
    N, S = sigmas.shape
    dev = sigmas.device
    f32 = torch.float32
    _cuda.check(sigmas, "sigmas", f32, (N, S), dev)
    _cuda.check(rgbs, "rgbs", f32, (N, S, 3), dev)
    _cuda.check(deltas, "deltas", f32, (N, S), dev)
    _cuda.check(ts, "ts", f32, (N, S), dev)
    if mask is not None:
        _cuda.check(mask, "mask", torch.bool, (N, S), dev)
    out = {
        "weights_sum": torch.empty((N,), dtype=f32, device=dev),
        "depth": torch.empty((N,), dtype=f32, device=dev),
        "image": torch.empty((N, 3), dtype=f32, device=dev),
        "weights": torch.empty((N, S), dtype=f32, device=dev),
    }
    _cuda.COMPOSITE(sigmas.data_ptr(), rgbs.data_ptr(), deltas.data_ptr(),
                    ts.data_ptr(), _cuda.ptr(mask), float(T_thresh), N, S,
                    out["weights_sum"].data_ptr(), out["depth"].data_ptr(),
                    out["image"].data_ptr(), out["weights"].data_ptr())
    return out
