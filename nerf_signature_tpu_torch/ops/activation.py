"""Truncated exponential (counterpart of
``nerf_signature_tpu/ops/activation.py``): forward is a plain ``exp``; the
backward clamps the input to [-15, 15] before exponentiating."""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)
