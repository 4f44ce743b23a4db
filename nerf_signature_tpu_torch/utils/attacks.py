"""Image attacks for robustness evaluation (counterpart of
``nerf_signature_tpu/utils/attacks.py``): pixel rounding and clamping, the
L-inf projection, PSNR, centre crop, resize, brightness, contrast, JPEG,
gaussian blur, and the named ``ATTACKS`` registry the attack sweep runs.

Randomness is explicit, as in ``utils/image.py``: ``attack_draws(name,
...)`` draws an entry's random inputs from a ``torch.Generator`` and every
registry entry is ``fn(x, draws)`` (a test hands over JAX's draws instead).
Images are [B, H, W, C] in [0, 1], channel-last.
"""

import torch
import torch.nn.functional as F

from .image import gaussian_blur3, rotate, scale
from .jpeg import diff_jpeg_ste, jpeg_dct


def round_pixel(x):
    """Quantise to the 8-bit pixel lattice with a straight-through gradient."""
    y = torch.round(x * 255.0) / 255.0
    return x + (y - x).detach()


def clamp_pixel(x):
    return torch.clamp(x, 0.0, 1.0)


def project_linf(x, y, radius):
    """Project x into the L-inf ball of ``radius`` (pixel units /255) around y."""
    delta = torch.clamp(x - y, -radius / 255.0, radius / 255.0)
    return y + delta


def psnr(x, y):
    mse = torch.mean((x - y) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


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


def _resize(x, h, w):
    """Bilinear resize of [B, H, W, C] to [B, h, w, C], antialiased when it
    shrinks (``jax.image.resize(..., "linear")``)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def resize_attack(x, factor):
    """Down-then-up resample through ``factor`` resolution (information loss)."""
    B, H, W, C = x.shape
    return _resize(_resize(x, max(1, int(H * factor)), max(1, int(W * factor))), H, W)


def adjust_brightness(x, factor):
    return torch.clamp(x * factor, 0.0, 1.0)


def adjust_contrast(x, factor):
    mean = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    return torch.clamp((x - mean) * factor + mean, 0.0, 1.0)


def jpeg_compress(x, quality=50, real_codec=False):
    if real_codec:
        return diff_jpeg_ste(x, int(quality))
    return jpeg_dct(x, float(quality))


def gaussian_blur(x, sigma):
    """3x3 gaussian blur, one sigma for the batch."""
    return gaussian_blur3(x, torch.full((x.shape[0],), float(sigma), device=x.device))


# the named attack registry of the sweep, in JAX's order: fn(x, draws)
ATTACKS = {
    "none": lambda x, draws: x,
    "jpeg_80": lambda x, draws: jpeg_compress(x, 80),
    "jpeg_50": lambda x, draws: jpeg_compress(x, 50),
    "noise_01": lambda x, draws: x + draws * 0.1,
    "blur": lambda x, draws: gaussian_blur(x, 0.5),
    "brightness_1_5": lambda x, draws: adjust_brightness(x, 1.5),
    "brightness_0_5": lambda x, draws: adjust_brightness(x, 0.5),
    "contrast_1_5": lambda x, draws: adjust_contrast(x, 1.5),
    "crop_50": lambda x, draws: center_crop(x, 0.5),
    "resize_50": lambda x, draws: resize_attack(x, 0.5),
    "rotation_15": lambda x, draws: rotate(x, draws),
    "scaling": lambda x, draws: scale(x, draws.expand(x.shape[0])),
    "round": lambda x, draws: round_pixel(x),
}


def attack_draws(name, shape, generator, device):
    """The random inputs of ``ATTACKS[name]`` for images of ``shape``
    [B, H, W, C], drawn from ``generator``; None for the deterministic ones."""
    if name not in ATTACKS:
        raise ValueError(f"unknown attack: {name}")
    if name == "noise_01":
        return torch.randn(tuple(shape), generator=generator, device=device)
    if name == "rotation_15":
        return torch.rand((shape[0],), generator=generator, device=device) * 30.0 - 15.0
    if name == "scaling":  # one factor for the batch
        return torch.rand((), generator=generator, device=device) * 0.5 + 0.75
    return None
