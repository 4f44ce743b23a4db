"""HiDDeN-style CNN bit extractor and watermark encoder (counterpart of
``nerf_signature_tpu/models/hidden.py``).

``ConvBNRelu`` = Conv3x3 (stride 1, pad 1) + BatchNorm (eps 1e-3, BATCH
statistics in train and eval alike, biased variance) + GELU (tanh
approximation, ``jax.nn.gelu``'s default); ``num_blocks`` of them, one more
to ``num_bits * redundancy`` channels, a global average pool, a linear
layer, the sum over the redundancy.  ImageNet normalisation.

Params are a plain dict laid out like the JAX tree, except that conv weights
are stored OIHW (torch's layout; JAX stores HWIO) and ``linear.w`` is
``[in, out]`` (``x @ w``).  ``train/checkpoint.py`` permutes at the
checkpoint boundary.  The public functions take images channel-last
([B, H, W, C], the JAX layout); the convs run in NCHW through cuDNN, as JAX
leaves them to XLA.

The prewatermark baseline (``train/prewatermark.py``) adds the encoder
(``HiddenEncoder``: conv blocks, the message broadcast and concatenated
with the features and the image, one more block, a 1x1 conv, tanh) and the
single-view decoder, whose BatchNorm keeps RUNNING statistics: with
``train=True`` it normalises by the batch's (biased variance, like
``jnp.var``) and moves the running mean and variance by ``momentum``
towards them; with ``train=False`` it normalises by the running ones.
"""

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device):
    """(mean, std) on ``device``, copied there once: a copy from the host
    cannot run inside a captured train step."""
    return (torch.as_tensor(_IMAGENET_MEAN, device=device),
            torch.as_tensor(_IMAGENET_STD, device=device))


def normalize_img(x):
    """x: [..., 3] in [0, 1] -> ImageNet-normalised (channel-last)."""
    mean, std = _imagenet_stats(x.device)
    return (x - mean) / std


def unnormalize_img(x):
    mean, std = _imagenet_stats(x.device)
    return x * std + mean


@dataclasses.dataclass(frozen=True)
class HiddenDecoderConfig:
    num_blocks: int = 8
    num_bits: int = 1
    redundancy: int = 1
    input_ch: int = 3        # n_views * 3 in the reference
    channels: int = 64
    bn_eps: float = 1e-3


def _uniform(generator, shape, bound, device):
    return ((torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound).to(device)


def _conv_init(generator, k, cin, cout, device):
    """torch Conv2d's default init, U(+-1/sqrt(fan_in)) for weight and bias;
    the weight OIHW."""
    bound = 1.0 / math.sqrt(cin * k * k)
    return {"w": _uniform(generator, (cout, cin, k, k), bound, device),
            "b": _uniform(generator, (cout,), bound, device)}


def _bn_init(ch, device):
    return {"scale": torch.ones((ch,), device=device), "bias": torch.zeros((ch,), device=device)}


def init_hidden_decoder(generator, cfg: HiddenDecoderConfig, device="cpu"):
    """Random decoder params from a (CPU) ``torch.Generator``."""
    blocks = []
    cin = cfg.input_ch
    for _ in range(cfg.num_blocks):
        blocks.append({"conv": _conv_init(generator, 3, cin, cfg.channels, device),
                       "bn": _bn_init(cfg.channels, device)})
        cin = cfg.channels
    out_ch = cfg.num_bits * cfg.redundancy
    head = {"conv": _conv_init(generator, 3, cfg.channels, out_ch, device),
            "bn": _bn_init(out_ch, device)}
    bound = 1.0 / math.sqrt(out_ch)
    linear = {"w": _uniform(generator, (out_ch, out_ch), bound, device),
              "b": _uniform(generator, (out_ch,), bound, device)}
    return {"blocks": blocks, "head": head, "linear": linear}


def decoder_leaves(params):
    """The decoder's tensors in the JAX tree's order (the optimizer's)."""
    out = []
    for p in list(params["blocks"]) + [params["head"]]:
        out += [p["bn"]["bias"], p["bn"]["scale"], p["conv"]["b"], p["conv"]["w"]]
    return out + [params["linear"]["b"], params["linear"]["w"]]


def _conv_bn_gelu(p, x, eps):
    """x [N, C, H, W]; batch statistics over (N, H, W), biased variance."""
    y = F.conv2d(x, p["conv"]["w"], p["conv"]["b"], padding=1)
    mean = y.mean(dim=(0, 2, 3), keepdim=True)
    var = ((y - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    yn = (y - mean) * torch.rsqrt(var + eps)
    yn = yn * p["bn"]["scale"][:, None, None] + p["bn"]["bias"][:, None, None]
    return F.gelu(yn, approximate="tanh")


def hidden_decoder_apply(params, cfg: HiddenDecoderConfig, x):
    """x: [B, H, W, input_ch] (already normalised) -> logits [B, num_bits].
    The batch statistics span the whole batch: decode one message's blocks
    a call (JAX vmaps the decode over messages)."""
    x = x.permute(0, 3, 1, 2)
    for p in params["blocks"]:
        x = _conv_bn_gelu(p, x, cfg.bn_eps)
    x = _conv_bn_gelu(params["head"], x, cfg.bn_eps)
    x = x.mean(dim=(2, 3))  # AdaptiveAvgPool2d((1, 1)) -> [B, out_ch]
    x = x @ params["linear"]["w"] + params["linear"]["b"]
    return x.reshape(-1, cfg.num_bits, cfg.redundancy).sum(-1)


def _conv(p, x):
    """Conv k x k (stride 1, 'SAME' padding) of x [N, C, H, W]."""
    return F.conv2d(x, p["w"], p["b"], padding=p["w"].shape[-1] // 2)


@dataclasses.dataclass(frozen=True)
class HiddenDecoderSingleConfig:
    """The single-view decoder (BatchNorm with running statistics)."""

    num_blocks: int = 7
    num_bits: int = 16
    channels: int = 64
    bn_eps: float = 1e-3
    momentum: float = 0.1


def init_hidden_decoder_single(generator, cfg: HiddenDecoderSingleConfig, device="cpu"):
    """(params {blocks, linear}, state {bn: [{mean, var}]}) from a (CPU)
    ``torch.Generator``; the running stats start at mean 0, variance 1."""
    blocks, state = [], []
    cin = 3
    for cout in [cfg.channels] * cfg.num_blocks + [cfg.num_bits]:
        blocks.append({"conv": _conv_init(generator, 3, cin, cout, device),
                       "bn": _bn_init(cout, device)})
        state.append({"mean": torch.zeros((cout,), device=device),
                      "var": torch.ones((cout,), device=device)})
        cin = cout
    bound = 1.0 / math.sqrt(cfg.num_bits)
    linear = {"w": _uniform(generator, (cfg.num_bits, cfg.num_bits), bound, device),
              "b": _uniform(generator, (cfg.num_bits,), bound, device)}
    return {"blocks": blocks, "linear": linear}, {"bn": state}


def hidden_decoder_single_apply(params, state, cfg: HiddenDecoderSingleConfig, x, train=False):
    """x [B, H, W, 3] (normalised) -> (logits [B, num_bits], new state).
    ``train``: batch statistics (biased variance), the running ones moved
    by ``momentum``; else the running statistics.  The state is returned,
    never written in place."""
    x = x.permute(0, 3, 1, 2)
    new_bn = []
    for p, s in zip(params["blocks"], state["bn"]):
        y = _conv(p["conv"], x)
        if train:
            mean = y.mean(dim=(0, 2, 3))
            var = ((y - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            new_bn.append({"mean": (1 - cfg.momentum) * s["mean"] + cfg.momentum * mean,
                           "var": (1 - cfg.momentum) * s["var"] + cfg.momentum * var})
        else:
            mean, var = s["mean"], s["var"]
            new_bn.append(s)
        y = (y - mean[None, :, None, None]) * torch.rsqrt(var + cfg.bn_eps)[None, :, None, None]
        x = F.gelu(y * p["bn"]["scale"][:, None, None] + p["bn"]["bias"][:, None, None],
                   approximate="tanh")
    x = x.mean(dim=(2, 3))
    return x @ params["linear"]["w"] + params["linear"]["b"], {"bn": new_bn}


@dataclasses.dataclass(frozen=True)
class HiddenEncoderConfig:
    num_blocks: int = 4
    num_bits: int = 16
    channels: int = 64
    last_tanh: bool = True
    bn_eps: float = 1e-3


def init_hidden_encoder(generator, cfg: HiddenEncoderConfig, device="cpu"):
    """Params {blocks, after, final} from a (CPU) ``torch.Generator``."""
    blocks = []
    cin = 3
    for _ in range(cfg.num_blocks):
        blocks.append({"conv": _conv_init(generator, 3, cin, cfg.channels, device),
                       "bn": _bn_init(cfg.channels, device)})
        cin = cfg.channels
    after = {"conv": _conv_init(generator, 3, cfg.channels + 3 + cfg.num_bits, cfg.channels,
                                device),
             "bn": _bn_init(cfg.channels, device)}
    return {"blocks": blocks, "after": after,
            "final": _conv_init(generator, 1, cfg.channels, 3, device)}


def hidden_encoder_apply(params, cfg: HiddenEncoderConfig, imgs, msgs):
    """imgs [B, H, W, 3], msgs [B, num_bits] -> the watermark residual
    [B, H, W, 3] (batch statistics in every BatchNorm)."""
    x = imgs.permute(0, 3, 1, 2)
    img = x
    for p in params["blocks"]:
        x = _conv_bn_gelu(p, x, cfg.bn_eps)
    B, _, H, W = img.shape
    m = msgs[:, :, None, None].expand(B, msgs.shape[-1], H, W)
    x = _conv_bn_gelu(params["after"], torch.cat([m, x, img], dim=1), cfg.bn_eps)
    x = _conv(params["final"], x)
    if cfg.last_tanh:
        x = torch.tanh(x)
    return x.permute(0, 2, 3, 1)
