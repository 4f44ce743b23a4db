"""Differentiable JPEG (counterpart of ``nerf_signature_tpu/utils/jpeg.py``).

  * ``jpeg_dct``: the JPEG transform as tensor ops — RGB -> YCbCr, 8x8 block
    DCT, quality-scaled quantisation (ITU-T T.81 Annex K tables) with a
    straight-through rounding, IDCT, YCbCr -> RGB.  The two 8x8 products a
    block are ``torch.matmul``s.  The watermark stage's jpeg distortion and
    the attack registry's ``jpeg_80`` / ``jpeg_50`` use it.
  * ``diff_jpeg_ste``: the real codec (PIL, on the host) with a
    straight-through gradient.  PIL is imported only when it runs.
  * ``random_diff_jpeg``: a quality from {low, low+10, ..., 90}, picked by an
    explicit index tensor (``jpeg_quality_index`` draws one).

Images are [B, H, W, 3] in [0, 1], channel-last.
"""

import functools
import io

import numpy as np
import torch

_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)
_Q_CHROMA = np.full((8, 8), 99, np.float32)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]


def _dct_matrix():
    n = 8
    k = np.arange(n)
    C = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    C[0] *= 1.0 / np.sqrt(2.0)
    return C.astype(np.float32)


_DCT = _dct_matrix()


@functools.lru_cache(maxsize=None)
def _constants(device):
    """(the DCT matrix [8, 8], the base tables [3, 8, 8]) on ``device``,
    copied there once (a copy a call costs more host time than the
    layer's kernels)."""
    return (torch.as_tensor(_DCT, device=device),
            torch.as_tensor(np.stack([_Q_LUMA, _Q_CHROMA, _Q_CHROMA]), device=device))


def _quality_scale(quality, device):
    q = (quality.to(device=device, dtype=torch.float32) if torch.is_tensor(quality)
         else torch.full((), float(quality), dtype=torch.float32, device=device))
    q = torch.clamp(q, 1.0, 100.0)
    return torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q) / 100.0


def quant_table(quality, device):
    """[3, 8, 8] quantisation steps (Y, Cb, Cr) at ``quality``."""
    device = torch.device(device)
    q = _constants(device)[1]
    return torch.clamp(torch.floor(q * _quality_scale(quality, device) + 0.5), 1.0, 255.0)


def _clip01(x):
    """clip to [0, 1] with ``jnp.clip``'s gradient: half the cotangent at a
    value on a bound (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _ste_round(x):
    return x + (torch.round(x) - x).detach()


def _rgb_to_ycbcr(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 0.5
    return torch.stack([y, cb, cr], dim=-1)


def _ycbcr_to_rgb(x):
    y, cb, cr = x[..., 0], x[..., 1] - 0.5, x[..., 2] - 0.5
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def _pad_to8(img):
    """Edge-pad H and W up to multiples of 8."""
    h, w = img.shape[-3], img.shape[-2]
    ph, pw = (-h) % 8, (-w) % 8
    if ph:
        img = torch.cat([img, img[..., -1:, :, :].expand(*img.shape[:-3], ph, w, 3)], -3)
    if pw:
        img = torch.cat([img, img[..., :, -1:, :].expand(*img.shape[:-2], pw, 3)], -2)
    return img, h, w


def dct_coefficients(images):
    """The block DCT of the level-shifted YCbCr image: [B, Hb, Wb, 3, 8, 8]
    (the input of the quantiser), and the unpadded (H, W)."""
    x, H, W = _pad_to8(_clip01(images))
    B, Hp, Wp, _ = x.shape
    ycc = _rgb_to_ycbcr(x) * 255.0 - 128.0
    blocks = ycc.reshape(B, Hp // 8, 8, Wp // 8, 8, 3).permute(0, 1, 3, 5, 2, 4)
    D = _constants(images.device)[0]
    return D @ blocks @ D.T, (H, W)


def jpeg_dct(images, quality=75.0):
    """Differentiable JPEG of images [B, H, W, 3] in [0, 1]; ``quality`` a
    float or a 0-d tensor."""
    coef, (H, W) = dct_coefficients(images)
    q = quant_table(quality, images.device)
    coef_q = _ste_round(coef / q) * q
    D = _constants(images.device)[0]
    rec = D.T @ coef_q @ D
    B, Hb, Wb = rec.shape[:3]
    rec = rec.permute(0, 1, 4, 2, 5, 3).reshape(B, Hb * 8, Wb * 8, 3)
    out = _ycbcr_to_rgb((rec + 128.0) / 255.0)
    return _clip01(out[:, :H, :W])


def _pil_jpeg_roundtrip(arr, quality):
    """Encode and decode each image [H, W, 3] with the real codec."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("diff_jpeg_ste runs the real JPEG codec through PIL, which is not "
                          "installed; the DCT model (jpeg_dct) needs no PIL") from e
    out = np.empty_like(arr)
    for i, img in enumerate(arr):
        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        buf = io.BytesIO()
        pil.save(buf, format="JPEG", quality=int(quality))
        buf.seek(0)
        out[i] = np.asarray(Image.open(buf), np.float32) / 255.0
    return out


class _DiffJpegSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, quality):
        arr = images.detach().float().cpu().numpy()
        return torch.from_numpy(_pil_jpeg_roundtrip(arr, quality)).to(images.device)

    @staticmethod
    def backward(ctx, g):
        return g, None  # straight-through


def diff_jpeg_ste(images, quality=50):
    """Real-codec JPEG (PIL) with a straight-through gradient; images
    [B, H, W, 3] in [0, 1]."""
    return _DiffJpegSTE.apply(images, int(quality))


def jpeg_qualities(low=40):
    return torch.arange(low, 100, 10, dtype=torch.float32)


def jpeg_quality_index(generator, device, low=40):
    """A uniform index into ``jpeg_qualities(low)`` (0-d int64)."""
    return torch.randint(0, len(jpeg_qualities(low)), (), generator=generator, device=device)


def random_diff_jpeg(images, index, low=40, use_dct=True):
    """JPEG at quality ``jpeg_qualities(low)[index]``: the DCT model, or the
    real codec (the quality read on the host)."""
    q = low + 10.0 * torch.as_tensor(index, device=images.device).to(torch.float32)
    if use_dct:
        return jpeg_dct(images, q)
    return diff_jpeg_ste(images, int(q.item()))
