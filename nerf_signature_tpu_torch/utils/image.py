"""Differentiable image distortions for watermark-robustness training
(counterpart of ``nerf_signature_tpu/utils/image.py``): none / noise
(sigma^2 = 0.1) / rotation (+-30 deg) / scaling (0.75-1.25) / blurring
(gaussian k = 3, sigma U(0.01, 0.5)) / brightness (multiply U(0.5, 1.5)) /
crop (central keep-area U(0.3, 0.9)) / jpeg (the DCT model at a quality
drawn from {40, 50, ..., 90}).

Randomness is explicit: ``distortion_draws`` draws a kind's random inputs
from a ``torch.Generator`` and ``distortion_layer`` takes them as tensors (a
test hands over JAX's draws instead).  Images are [B, h, w, 3] in [0, 1],
channel-last.  Rotation and scaling are affine warps with bilinear sampling
where every corner outside the image counts as 0, like JAX's
``map_coordinates(order=1, mode="constant", cval=0)``: ``grid_sample`` with
``align_corners=True`` and zero padding, in pixel coordinates.
"""

import functools
import math

import torch
import torch.nn.functional as F

from .jpeg import jpeg_quality_index, random_diff_jpeg


def _grid(h, w, device):
    r = torch.arange(h, dtype=torch.float32, device=device)
    c = torch.arange(w, dtype=torch.float32, device=device)
    return torch.meshgrid(r, c, indexing="ij")


def _warp(images, src_r, src_c):
    """Bilinear sample of images [B, h, w, c] at pixel positions src_r/src_c
    [B, h, w]; a corner outside the image contributes 0."""
    B, h, w, _ = images.shape
    gx = src_c / (w - 1) * 2.0 - 1.0
    gy = src_r / (h - 1) * 2.0 - 1.0
    out = F.grid_sample(images.permute(0, 3, 1, 2), torch.stack([gx, gy], -1),
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def rotate(images, angles_deg):
    """images [B, h, w, c]; angles [B] in degrees (the inverse map)."""
    B, h, w, _ = images.shape
    rr, cc = _grid(h, w, images.device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    t = (-angles_deg * math.pi / 180.0)[:, None, None]
    cos, sin = torch.cos(t), torch.sin(t)
    r0, c0 = rr - cy, cc - cx
    return _warp(images, cos * r0 - sin * c0 + cy, sin * r0 + cos * c0 + cx)


def scale(images, factors):
    """Isotropic rescale about the centre on the same canvas; factors [B]."""
    B, h, w, _ = images.shape
    rr, cc = _grid(h, w, images.device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    s = factors[:, None, None]
    return _warp(images, (rr - cy) / s + cy, (cc - cx) / s + cx)


@functools.lru_cache(maxsize=None)
def _taps(device):
    """The 3-tap offsets on ``device``, copied there once (no host copy
    inside a captured step)."""
    return torch.tensor([-1.0, 0.0, 1.0], device=device)


def gaussian_blur3(images, sigmas):
    """3x3 gaussian blur with a sigma per image, edges replicated."""
    x = _taps(images.device)
    k = torch.exp(-(x**2) / (2 * sigmas[:, None] ** 2))
    k = (k / k.sum(-1, keepdim=True))[:, :, None, None, None]  # [B, 3, 1, 1, 1]
    p = torch.cat([images[:, :1], images, images[:, -1:]], 1)
    img = p[:, :-2] * k[:, 0] + p[:, 1:-1] * k[:, 1] + p[:, 2:] * k[:, 2]
    p = torch.cat([img[:, :, :1], img, img[:, :, -1:]], 2)
    return p[:, :, :-2] * k[:, 0] + p[:, :, 1:-1] * k[:, 1] + p[:, :, 2:] * k[:, 2]


def distortion_draws(kind, shape, generator, device):
    """The random inputs of ``distortion_layer(kind)`` for images of
    ``shape`` [B, h, w, c], drawn from ``generator``; None for "none"."""
    B = shape[0]

    def uniform(size, lo, hi):
        u = torch.rand(size, generator=generator, device=device)
        return u * (hi - lo) + lo

    if kind == "none":
        return None
    if kind == "noise":
        return torch.randn(tuple(shape), generator=generator, device=device)
    if kind == "rotation":
        return uniform((B,), -30.0, 30.0)
    if kind == "scaling":
        return uniform((), 0.75, 1.25)  # one factor per batch, like the reference
    if kind == "blurring":
        return uniform((B,), 0.01, 0.5)
    if kind == "brightness":
        return uniform((B, 1, 1, 1), 0.5, 1.5)
    if kind == "crop":
        return uniform((), 0.3, 0.9)
    if kind == "jpeg":
        return jpeg_quality_index(generator, device, low=40)
    raise ValueError(f"unknown distortion: {kind}")


def distortion_layer(images, kind="none", draws=None):
    """images [B, h, w, 3] in [0, 1] with the kind's draws (see
    ``distortion_draws``).  Differentiable w.r.t. images."""
    if kind == "none":
        return images
    if kind == "noise":
        return images + draws * math.sqrt(0.1)
    if kind == "rotation":
        return rotate(images, draws)
    if kind == "scaling":
        return scale(images, draws.expand(images.shape[0]))
    if kind == "blurring":
        return gaussian_blur3(images, draws)
    if kind == "brightness":
        return images * draws
    if kind == "crop":
        from .attacks import center_crop  # attacks imports this module

        return center_crop(images, draws)
    if kind == "jpeg":
        return random_diff_jpeg(images, draws, low=40, use_dct=True)
    raise ValueError(f"unknown distortion: {kind}")
