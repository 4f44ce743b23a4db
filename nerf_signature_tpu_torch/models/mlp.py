"""Tiny bias-free ReLU MLPs (counterpart of
``nerf_signature_tpu/models/mlp.py``).  Weights are ``[in, out]``, like the
JAX package.  The render path runs both NGP heads fused in the field kernel
(``models.ngp.field_heads``); ``mlp_apply`` is the plain version it is held
against."""

import math

import torch


def init_mlp(generator, dims, device="cpu"):
    """dims: [in, hidden..., out].  He-uniform, bias-free (tcnn-style)."""
    params = []
    for i in range(len(dims) - 1):
        bound = math.sqrt(6.0 / dims[i])
        w = torch.rand((dims[i], dims[i + 1]), generator=generator,
                       dtype=torch.float32)
        params.append((w * (2 * bound) - bound).to(device))
    return params


def mlp_apply(params, x, *, compute_dtype=None):
    """ReLU MLP with a linear output, computed in ``compute_dtype``; returns
    float32.  In bf16 every layer's output is rounded to bf16 before the
    ReLU, exactly where ``jnp.dot(..., preferred_element_type=bf16)`` rounds
    it; only the last layer's output is cast back to fp32."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for i, w in enumerate(params):
        w_c = w.to(compute_dtype) if compute_dtype is not None else w
        x = torch.matmul(x, w_c)
        if i < len(params) - 1:
            x = torch.relu(x)
    return x.float()
