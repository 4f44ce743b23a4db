"""Inverse-CDF importance sampling along rays (plain PyTorch).

Counterpart of ``nerf_signature_tpu/ops/pdf.py:sample_pdf``: the fixed-step
renderer's upsampling (``upsample_steps > 0``).  The uniforms are an explicit
argument (JAX draws them from a key), and ``det=True`` takes the midpoints
of ``n_samples`` equal bins instead.  JAX runs it as XLA ops outside any
Pallas kernel; so does the port.
"""

import torch


def sample_pdf(bins, weights, n_samples, det=False, u=None):
    """bins: [B, T] z-values, weights: [B, T-1] bin weights; ``u``: [B,
    n_samples] U[0, 1) draws (ignored when ``det``).

    Returns [B, n_samples] new z-values drawn proportionally to weights."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, T]

    B = cdf.shape[0]
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device).expand(B, n_samples)
    elif u is None:
        raise ValueError("sample_pdf: pass the uniforms u, or det=True")
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)

    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, 1.0, denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
