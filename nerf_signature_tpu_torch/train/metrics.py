"""Evaluation metric meters: PSNR, SSIM and an inert LPIPS (numpy copies of
``nerf_signature_tpu/train/metrics.py``; bit accuracy comes with the
watermark slice).

Equivalents of ``nerf/utils_wtmk_disen.py:211-319`` (PSNRMeter / SSIMMeter /
LPIPSMeter).  SSIM is gaussian 11x11, sigma 1.5 (the torchmetrics default
the reference uses).
"""

import numpy as np


class _Meter:
    def __init__(self):
        self.V = 0.0
        self.N = 0

    def clear(self):
        self.V, self.N = 0.0, 0

    def measure(self):
        return self.V / max(self.N, 1)

    def report(self):
        return f"{type(self).__name__} = {self.measure():.6f}"


class PSNRMeter(_Meter):
    """PSNR = -10 log10 MSE, ref ``utils_wtmk_disen.py:211-245``."""

    name = "PSNR"

    def update(self, preds, truths):
        preds = np.asarray(preds, np.float32)
        truths = np.asarray(truths, np.float32)
        mse = np.mean((preds - truths) ** 2)
        self.V += -10.0 * np.log10(max(mse, 1e-12))
        self.N += 1


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(img1, img2, data_range=1.0, size=11, sigma=1.5):
    """Per-image SSIM over [H, W, C] float arrays (separable gaussian window),
    matching torchmetrics' StructuralSimilarityIndexMeasure defaults."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    k = _gaussian_kernel(size, sigma)

    def blur(x):
        # separable conv along H then W with reflect-free 'valid' region
        x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 0, x)
        x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 1, x)
        return x

    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = blur(img1**2) - mu1_sq
    s2 = blur(img2**2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    )
    return float(m.mean())


class SSIMMeter(_Meter):
    name = "SSIM"

    def update(self, preds, truths):
        preds = np.asarray(preds, np.float32)
        truths = np.asarray(truths, np.float32)
        if preds.ndim == 4:  # [B, H, W, C]
            for p, t in zip(preds, truths):
                self.V += ssim(p, t)
                self.N += 1
        else:
            self.V += ssim(preds, truths)
            self.N += 1


class LPIPSMeter(_Meter):
    """LPIPS: explicitly inert, like the JAX package without weights --
    ``measure()`` is None and ``report()`` says n/a.  The repo ships no LPIPS
    weights, and the port's LPIPS network is not written yet."""

    name = "LPIPS"

    def __init__(self, net="alex", weights_path=None):
        super().__init__()
        self.weights_path = weights_path

    @property
    def available(self):
        return False

    def update(self, preds, truths):
        return

    def measure(self):
        return None

    def report(self):
        return f"{type(self).__name__} = n/a (lpips weights unavailable)"
