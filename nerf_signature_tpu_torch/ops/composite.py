"""Front-to-back compositing with early termination (K3).

Counterpart of ``nerf_signature_tpu/ops/composite.py``: with
``tau = sigma * dt``, the transmittance entering sample i is
``T_in = exp(-(cumsum(tau) - tau))`` (inclusive cumsum, then minus tau,
exactly as the JAX formula writes it) and the weight is
``(1 - exp(-tau)) * T_in``, zero where ``T_in < T_thresh`` or masked.

``composite_rays`` is the kernel wrapper (``csrc/composite.cu`` on CUDA
tensors, ``composite_rays_plain`` on CPU ones).  Under autograd the CUDA
path is ``CompositeFn``, whose backward is the analytic K3 backward kernel;
the CPU path is autograd through ``composite_rays_plain`` (the closed form,
as JAX differentiates it).
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
    """K3 wrapper; same arguments and outputs as ``composite_rays_plain``.
    Differentiable in ``sigmas`` and ``rgbs``."""
    if not sigmas.is_cuda:
        return composite_rays_plain(sigmas, rgbs, deltas, ts, mask, T_thresh)
    if _cuda.needs_grad(sigmas, rgbs):
        ws, depth, image, weights = CompositeFn.apply(sigmas, rgbs, deltas, ts, mask,
                                                      float(T_thresh))
        return {"weights_sum": ws, "depth": depth, "image": image, "weights": weights}
    return _composite_kernel(sigmas, rgbs, deltas, ts, mask, T_thresh)


def _check_inputs(sigmas, rgbs, deltas, ts, mask):
    N, S = sigmas.shape
    dev = sigmas.device
    f32 = torch.float32
    _cuda.check(sigmas, "sigmas", f32, (N, S), dev)
    _cuda.check(rgbs, "rgbs", f32, (N, S, 3), dev)
    _cuda.check(deltas, "deltas", f32, (N, S), dev)
    _cuda.check(ts, "ts", f32, (N, S), dev)
    if mask is not None:
        _cuda.check(mask, "mask", torch.bool, (N, S), dev)
    return N, S, dev


def _composite_kernel(sigmas, rgbs, deltas, ts, mask, T_thresh):
    N, S, dev = _check_inputs(sigmas, rgbs, deltas, ts, mask)
    f32 = torch.float32
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


def composite_rays_bwd(sigmas, rgbs, deltas, ts, mask, T_thresh, g_ws=None,
                       g_depth=None, g_image=None, g_weights=None):
    """The K3 backward kernel: (g_sigmas [N, S], g_rgbs [N, S, 3]) from the
    cotangents of the four outputs (None = zero)."""
    N, S, dev = _check_inputs(sigmas, rgbs, deltas, ts, mask)
    f32 = torch.float32
    for name, g, shape in (("g_ws", g_ws, (N,)), ("g_depth", g_depth, (N,)),
                           ("g_image", g_image, (N, 3)), ("g_weights", g_weights, (N, S))):
        if g is not None:
            _cuda.check(g, name, f32, shape, dev)
    g_sigmas = torch.empty((N, S), dtype=f32, device=dev)
    g_rgbs = torch.empty((N, S, 3), dtype=f32, device=dev)
    _cuda.COMPOSITE_BWD(sigmas.data_ptr(), rgbs.data_ptr(), deltas.data_ptr(), ts.data_ptr(),
                        _cuda.ptr(mask), float(T_thresh), N, S, _cuda.ptr(g_ws),
                        _cuda.ptr(g_depth), _cuda.ptr(g_image), _cuda.ptr(g_weights),
                        g_sigmas.data_ptr(), g_rgbs.data_ptr())
    return g_sigmas, g_rgbs


class CompositeFn(torch.autograd.Function):
    """K3 forward and backward; gradients to sigmas and rgbs (deltas, ts and
    the mask carry no parameters)."""

    @staticmethod
    def forward(ctx, sigmas, rgbs, deltas, ts, mask, T_thresh):
        out = _composite_kernel(sigmas, rgbs, deltas, ts, mask, T_thresh)
        ctx.save_for_backward(sigmas, rgbs, deltas, ts, mask)
        ctx.T_thresh = T_thresh
        ctx.set_materialize_grads(False)
        return out["weights_sum"], out["depth"], out["image"], out["weights"]

    @staticmethod
    def backward(ctx, g_ws, g_depth, g_image, g_weights):
        sigmas, rgbs, deltas, ts, mask = ctx.saved_tensors
        g = [None if v is None else v.contiguous()
             for v in (g_ws, g_depth, g_image, g_weights)]
        g_sigmas, g_rgbs = composite_rays_bwd(sigmas, rgbs, deltas, ts, mask, ctx.T_thresh, *g)
        return g_sigmas, g_rgbs, None, None, None, None
