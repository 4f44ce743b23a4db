"""Image attacks (counterpart of ``nerf_signature_tpu/utils/attacks.py``).
Only ``center_crop`` is ported: the watermark stage's ``crop`` distortion
uses it.  The attack suites are ROADMAP queue 1 ("attacks").  Images are
[B, H, W, C] in [0, 1], channel-last.
"""

import torch


def center_crop(x, frac):
    """Keep the central ``frac`` area (sqrt(frac) per side), zero outside —
    the shape-static crop attack."""
    B, H, W, C = x.shape
    side = torch.sqrt(torch.as_tensor(frac, dtype=torch.float32, device=x.device))
    h2 = H * side / 2.0
    w2 = W * side / 2.0
    rr = torch.arange(H, device=x.device)[:, None]
    cc = torch.arange(W, device=x.device)[None, :]
    mask = (torch.abs(rr - (H - 1) / 2.0) <= h2) & (torch.abs(cc - (W - 1) / 2.0) <= w2)
    return x * mask[None, :, :, None]
