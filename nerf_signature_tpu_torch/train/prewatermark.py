"""Prewatermarking baseline (counterpart of
``nerf_signature_tpu/train/prewatermark.py``): watermark the 2D training
images first, train a fresh NeRF on them, then measure whether the bits
survive novel-view rendering.

  1. ``pretrain_hidden``: train the HiDDeN encoder and single-view decoder
     (``models/hidden.py``) together on random crops of the scene's own
     images: BCE on the decoded bits + ``lambda_res`` * the residual's mean
     square, with additive noise in the loop; Adam (0.9, 0.999, eps 1e-8:
     optax's ``adam``),
  2. ``watermark_images``: embed one owner message into every training
     image (the tanh residual, strength-scaled, clipped to [0, 1]),
  3. the clean trainer (``train/trainer.py``) fits an NGP to them,
  4. ``bit_survival``: decode the message from rendered views with the
     decoder's running BatchNorm statistics, and report the sign-agreement
     bit accuracy.

Randomness is explicit: the crops and bits are host numpy from
``np.random.default_rng(seed)`` (JAX's stream, so both packages train on
the same crops), the init from a ``torch.Generator`` seeded with ``seed``,
the noise a draw the caller may hand over (``noise``: step, shape ->
tensor), by default from a generator seeded with ``seed``.  The convs run
through cuDNN on the card, as the watermark decoder's do.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..models.hidden import (
    HiddenDecoderSingleConfig,
    HiddenEncoderConfig,
    hidden_decoder_single_apply,
    hidden_encoder_apply,
    init_hidden_decoder_single,
    init_hidden_encoder,
    normalize_img,
)


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, list):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def _bce_logits(logits, bits):
    """``mean(optax.sigmoid_binary_cross_entropy(logits, bits))``."""
    return torch.mean(-bits * F.logsigmoid(logits) - (1.0 - bits) * F.logsigmoid(-logits))


def pretrain_loss(params, dec_state, enc_cfg, dec_cfg, imgs, bits, noise, strength=0.1,
                  lambda_res=0.01):
    """One step's objective: (loss, (bit accuracy, the decoder's new state)).
    imgs [B, c, c, 3], bits [B, D] 0/1 float, noise [B, c, c, 3] (already
    scaled by the noise's standard deviation)."""
    residual = hidden_encoder_apply(params["enc"], enc_cfg, imgs, bits)
    wm = torch.clamp(imgs + strength * residual, 0.0, 1.0)
    x = normalize_img(torch.clamp(wm + noise, 0.0, 1.0))
    logits, new_state = hidden_decoder_single_apply(params["dec"], dec_state, dec_cfg, x,
                                                    train=True)
    loss = _bce_logits(logits, bits) + lambda_res * torch.mean(residual**2)
    acc = torch.mean(((logits > 0) == (bits > 0.5)).to(torch.float32))
    return loss, (acc, new_state)


def pretrain_hidden(images, message_dim, steps=600, crop=64, batch=8, lr=1e-3, strength=0.1,
                    lambda_res=0.01, noise_std=0.02, seed=0, log=print, channels=64,
                    dec_blocks=8, enc_blocks=4, device="cpu", init=None, noise=None):
    """Train a HiDDeN encoder/decoder pair on random crops of ``images``
    ([N, H, W, 3] in [0, 1], host numpy).  ``init``: (enc params, dec params,
    dec state) to start from instead of the seeded init; ``noise``: step,
    shape -> the unscaled standard-normal draw of that step.  Returns
    (enc_params, {'params', 'state'}, enc_cfg, dec_cfg)."""
    enc_cfg = HiddenEncoderConfig(num_bits=message_dim, channels=channels, num_blocks=enc_blocks)
    dec_cfg = HiddenDecoderSingleConfig(num_blocks=dec_blocks, num_bits=message_dim,
                                        channels=channels)
    if init is None:
        g = torch.Generator().manual_seed(seed)
        enc = init_hidden_encoder(g, enc_cfg, device)
        dec_params, dec_state = init_hidden_decoder_single(g, dec_cfg, device)
    else:
        enc, dec_params, dec_state = init
    params = {"enc": enc, "dec": dec_params}
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if noise is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        noise = lambda i, shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    rng = np.random.default_rng(seed)
    N, H, W = images.shape[:3]
    c = min(crop, H, W)
    for i in range(steps):
        idx = rng.integers(0, N, batch)
        ys = rng.integers(0, H - c + 1, batch)
        xs = rng.integers(0, W - c + 1, batch)
        crops = np.stack([images[n, y:y + c, x:x + c, :3] for n, y, x in zip(idx, ys, xs)]
                         ).astype(np.float32)
        bits = rng.integers(0, 2, (batch, message_dim)).astype(np.float32)
        imgs = torch.as_tensor(crops, device=device)
        b = torch.as_tensor(bits, device=device)
        loss, (acc, dec_state) = pretrain_loss(
            params, dec_state, enc_cfg, dec_cfg, imgs, b, noise_std * noise(i, imgs.shape),
            strength, lambda_res)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        dec_state = {"bn": [{k: v.detach() for k, v in s.items()} for s in dec_state["bn"]]}
        if log is not None and (i + 1) % max(1, steps // 5) == 0:
            log(f"[prewatermark] hidden pretrain {i + 1}/{steps} "
                f"loss={float(loss.detach()):.4f} bit_acc={float(acc):.4f}")
    for p in leaves:
        p.requires_grad_(False)
    return params["enc"], {"params": params["dec"], "state": dec_state}, enc_cfg, dec_cfg


@torch.no_grad()
def watermark_images(enc_params, enc_cfg, images, message, strength=0.1, chunk=4):
    """Embed ``message`` ([D] 0/1) into every image ([N, H, W, 3+] in
    [0, 1], host numpy), ``chunk`` images a batch (the encoder's batch
    statistics span a chunk, as in JAX).  Returns numpy [N, H, W, 3]."""
    device = enc_params["final"]["w"].device
    msg = torch.as_tensor(np.asarray(message, np.float32), device=device)[None]
    out = []
    for i in range(0, images.shape[0], chunk):
        imgs = torch.as_tensor(np.asarray(images[i:i + chunk, ..., :3], np.float32),
                               device=device)
        bits = msg.expand(imgs.shape[0], msg.shape[-1])
        residual = hidden_encoder_apply(enc_params, enc_cfg, imgs, bits)
        out.append(torch.clamp(imgs + strength * residual, 0.0, 1.0).cpu().numpy())
    return np.concatenate(out, axis=0)


@torch.no_grad()
def bit_survival(dec, dec_cfg, renders, message):
    """Decode ``message`` from rendered views ([N, H, W, 3+] in [0, 1])
    one view at a time on the running statistics.  Returns (bit accuracy,
    per-view accuracies)."""
    device = dec["params"]["linear"]["w"].device
    msg = np.asarray(message) > 0.5
    per_view = []
    for i in range(renders.shape[0]):
        x = torch.as_tensor(np.asarray(renders[i:i + 1, ..., :3], np.float32), device=device)
        logits, _ = hidden_decoder_single_apply(dec["params"], dec["state"], dec_cfg,
                                                normalize_img(x), train=False)
        per_view.append(float(np.mean((logits[0].cpu().numpy() > 0) == msg)))
    return float(np.mean(per_view)), per_view
