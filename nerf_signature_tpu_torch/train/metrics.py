"""Evaluation metric meters: PSNR, SSIM, LPIPS (inert without weights) and the watermark's
bit accuracy with its binomial p-value (numpy copies of
``nerf_signature_tpu/train/metrics.py``), and ``ssim_torch``, the
differentiable SSIM of the patch guard (``--lambda_ssim``).

Equivalents of ``nerf/utils_wtmk_disen.py:211-319`` (PSNRMeter / SSIMMeter /
LPIPSMeter).  SSIM is gaussian 11x11, sigma 1.5 (the torchmetrics default
the reference uses).
"""

import functools

import numpy as np
import torch


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


@functools.lru_cache(maxsize=None)
def _valid_window(n, size, sigma, device):
    """[n - size + 1, n] float32 on ``device``: row r holds the gaussian
    window at columns r..r + size - 1 (the 'valid' convolution as a
    matrix).  Made once a device: a captured step copies nothing from the
    host."""
    k = _gaussian_kernel(size, sigma)
    m = np.zeros((n - size + 1, n), np.float32)
    for r in range(n - size + 1):
        m[r, r:r + size] = k
    return torch.from_numpy(m).to(device)


def ssim_torch(img1, img2, data_range=1.0, size=11, sigma=1.5):
    """Differentiable SSIM over [B, H, W, C] tensors, the mean over every
    window (JAX's ``ssim_jnp``): the gaussian blur as two 'valid'
    convolution matrices applied by einsum, the window shrunk to the
    largest odd size that fits a patch smaller than 11.  Plain PyTorch: two
    small products a term."""
    H, W = int(img1.shape[-3]), int(img1.shape[-2])
    size = min(size, H - (1 - H % 2), W - (1 - W % 2))
    KH = _valid_window(H, size, sigma, img1.device)
    KW = _valid_window(W, size, sigma, img1.device)

    def blur(x):
        x = torch.einsum("oh,...hwc->...owc", KH, x)
        return torch.einsum("ow,...hwc->...hoc", KW, x)

    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = blur(img1**2) - mu1_sq
    s2 = blur(img2**2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m.mean()


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
    """LPIPS (alex) through ``utils/lpips.py`` when weights resolve (a
    ``--lpips_weights`` / ``$LPIPS_WEIGHTS`` file or the ``lpips`` package),
    on ``device`` (the card unless ``"cpu"``); otherwise explicitly inert,
    like the JAX package's: ``measure()`` is None and ``report()`` says n/a.
    A named weights file that does not exist raises."""

    name = "LPIPS"

    def __init__(self, net="alex", weights_path=None, device=None):
        super().__init__()
        from ..utils.device import resolve_device
        from ..utils.lpips import load_lpips_params

        params = load_lpips_params(weights_path)
        if params is not None:  # the card is needed only when there is work for it
            dev = resolve_device(device)
            params = {"convs": [{k: v.to(dev) for k, v in c.items()} for c in params["convs"]],
                      "lins": [v.to(dev) for v in params["lins"]]}
        self._params = params

    @property
    def available(self):
        return self._params is not None

    def update(self, preds, truths):
        if self._params is None:
            return
        from ..utils.lpips import lpips_metric

        preds = np.asarray(preds, np.float32)
        truths = np.asarray(truths, np.float32)
        if preds.ndim == 3:
            preds, truths = preds[None], truths[None]
        self.V += lpips_metric(self._params, preds, truths)
        self.N += 1

    def measure(self):
        return self.V / max(self.N, 1) if self._params is not None else None

    def report(self):
        if self._params is None:
            return f"{type(self).__name__} = n/a (lpips weights unavailable)"
        return super().report()


class BitAccMeter(_Meter):
    """Sign-agreement bit accuracy, ref BIT_ACC (``utils_wtmk_disen.py:321-361``):
    acc = mean(~XOR(decoded > 0, truth > 0)); truths are 0/1 bits compared as
    (2b-1) > 0."""

    name = "BitAcc"

    def __init__(self):
        super().__init__()
        self.records = []
        self.bits_total = 0
        self.bits_correct = 0

    def clear(self):
        super().clear()
        self.records = []
        self.bits_total = 0
        self.bits_correct = 0

    def update(self, decoded, bits):
        decoded = np.asarray(decoded, np.float32).reshape(-1)
        bits = np.asarray(bits, np.float32).reshape(-1)
        agree = (decoded > 0) == (bits > 0.5)
        acc = float(agree.mean())
        self.records.append(acc)
        self.V += acc
        self.N += 1
        self.bits_total += agree.size
        self.bits_correct += int(agree.sum())

    def pvalue(self):
        """Ownership significance as **log10(p)**: the exact binomial tail
        P(X >= correct bits | random guessing, p = 0.5) over all evaluated
        bits, summed in log space (200 messages x 32 bits at accuracy 1.0 is
        p = 2^-6400, far below float underflow)."""
        n, k = self.bits_total, self.bits_correct
        if n == 0:
            return None
        from math import exp, lgamma, log
        log_half_n = n * log(0.5)
        terms = [lgamma(n + 1) - lgamma(j + 1) - lgamma(n - j + 1) + log_half_n
                 for j in range(k, n + 1)]
        m = max(terms)
        return (m + log(sum(exp(t - m) for t in terms))) / log(10.0)

    def significance(self):
        """Human-readable ownership-evidence string."""
        l10 = self.pvalue()
        if l10 is None:
            return "n/a"
        if l10 > -4:
            return f"p={10 ** l10:.2g}"
        return f"p=1e{l10:.0f}"
