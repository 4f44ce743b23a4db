"""Watermarked NGP field: a frozen clean backbone, the codebook message
encoder and the HiDDeN bit extractor (counterpart of
``nerf_signature_tpu/models/watermark.py``).

The message feature (one single-level hash encode of the effective table,
K9 then K1) is added to one level's 2 features of the backbone's 32
(``hash_select`` 1-3), or to all of them through one level-shared table
(``hash_select`` 0).  The backbone takes no gradient: its tensors do not
require grad, so K1's backward skips its table and K4 runs its feature-only
backward.  Params: ``backbone`` is an NGP params dict; ``trainable`` is
``{"msg_tables": [D, 2, T, F], "decoder": {...}}``.

Like ``field_params`` for the clean model, ``wtmk_field_params`` computes
once per render (or train step) what every chunk reuses: the backbone's
gather-dtype table and packed MLP weights, and the message's effective
table in fp32 and in the gather dtype.  The CopyRNeRF baseline and the
whole-image mode are not ported yet.
"""

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .hidden import HiddenDecoderConfig, init_hidden_decoder
from .message import effective_table, init_msg_tables
from .ngp import NGPConfig, _encode_pos, field_heads, field_heads_plain, field_params, init_ngp_params
from ..ops.hashenc import hash_encode

COPYRNERF_TODO = ("--copyrnerf (the CopyRNeRF colour-space baseline) is ROADMAP queue 1 item "
                  "'whole_image/copyrnerf/film/finetune_decoder', not ported yet")
WHOLE_IMAGE_TODO = ("--whole_image_wm (whole-image extraction) is ROADMAP queue 1 item "
                    "'whole_image/copyrnerf/film/finetune_decoder', not ported yet")


@dataclasses.dataclass(frozen=True)
class WatermarkConfig:
    ngp: NGPConfig = dataclasses.field(default_factory=NGPConfig)
    message_dim: int = 16
    n_views: int = 1
    msg_resolution: int = 2048
    msg_log2_hashmap_size: int = 19
    # where the message feature lives: 1 = the finest level (paper default),
    # 2 = the coarsest, 3 = the middle level, 0 = all levels (one shared table)
    hash_select: int = 1
    finetune_decoder: bool = False
    whole_image: bool = False
    copyrnerf: bool = False
    copyrnerf_replace: bool = False

    def __post_init__(self):
        if self.copyrnerf or self.copyrnerf_replace:
            raise NotImplementedError(COPYRNERF_TODO)
        if self.whole_image:
            raise NotImplementedError(WHOLE_IMAGE_TODO)

    @property
    def decoder(self) -> HiddenDecoderConfig:
        return HiddenDecoderConfig(num_blocks=8, num_bits=1, redundancy=1,
                                   input_ch=self.n_views * 3, channels=64)


def init_watermark_params(generator, cfg: WatermarkConfig, device="cpu") -> Dict[str, Any]:
    """{'backbone': NGP params, 'trainable': {'msg_tables', 'decoder'}} from
    a (CPU) ``torch.Generator``."""
    backbone = init_ngp_params(generator, cfg.ngp, device)
    tables = init_msg_tables(generator, cfg.message_dim, cfg.ngp.n_features,
                             cfg.msg_log2_hashmap_size, device)
    return {"backbone": backbone,
            "trainable": {"msg_tables": tables,
                          "decoder": init_hidden_decoder(generator, cfg.decoder, device)}}


def msg_encode_placement(cfg: WatermarkConfig):
    """(resolutions, shared_table, feature_offset) for ``cfg.hash_select``;
    the offset is None in the all-levels mode."""
    res = cfg.ngp.resolutions
    if cfg.hash_select == 1:
        return (np.array([float(cfg.msg_resolution)]), False,
                cfg.ngp.enc_dim - cfg.ngp.n_features)
    if cfg.hash_select == 2:
        return np.array([float(res[0])]), False, 0
    if cfg.hash_select == 3:
        mid = cfg.ngp.n_levels // 2 - 1
        return np.array([float(res[mid])]), False, mid * cfg.ngp.n_features
    if cfg.hash_select == 0:
        return np.asarray(res, np.float64), True, None
    raise ValueError(f"hash_select must be 0..3, got {cfg.hash_select}")


def wtmk_field_params(backbone, trainable, cfg: WatermarkConfig, message, plain=False,
                      backbone_fp=None):
    """The per-render buffers: ``field_params(backbone)`` (or the caller's
    cached ``backbone_fp``) plus, when ``message`` is given, ``msg_eff`` (the
    effective table, differentiable in the msg tables) and ``msg_eff_g``
    (its gather-dtype copy), from K9 unless ``plain``."""
    fp = dict(backbone_fp if backbone_fp is not None else field_params(backbone, cfg.ngp))
    fp["msg_eff"] = fp["msg_eff_g"] = None
    if message is not None:
        fp["msg_eff"], fp["msg_eff_g"] = effective_table(
            trainable["msg_tables"], message, cfg.ngp.compute_dtype, plain)
    return fp


def _msg_feature_from(fp, cfg: WatermarkConfig, x01, plain=False, pitch=None):
    resolutions, shared, _ = msg_encode_placement(cfg)
    return hash_encode(x01, fp["msg_eff"], resolutions, cfg.msg_log2_hashmap_size,
                       gather_dtype=cfg.ngp.compute_dtype, shared_table=shared,
                       table_g=fp["msg_eff_g"], plain=plain, pitch=pitch)


def _msg_feature(trainable, cfg: WatermarkConfig, x01, message, plain=False):
    """The message feature [M, F] (or [M, enc_dim] in the all-levels mode)."""
    fp = {}
    fp["msg_eff"], fp["msg_eff_g"] = effective_table(
        trainable["msg_tables"], message, cfg.ngp.compute_dtype, plain)
    return _msg_feature_from(fp, cfg, x01, plain)


def _encode_with_message(fp, cfg: WatermarkConfig, x, plain=False):
    """Backbone hash features [M, enc_dim] (on the kernel path at
    ``feature_pitch``, the padded columns zero) with the message feature
    added (no message: the backbone's alone)."""
    feat = _encode_pos(fp, cfg.ngp, x, plain)
    if fp.get("msg_eff") is None:
        return feat
    ngp = cfg.ngp
    bound = torch.tensor(ngp.bound, dtype=torch.float32, device=x.device)
    x01 = (x + bound) / (2.0 * bound)
    _, _, off = msg_encode_placement(cfg)
    # all levels: the message feature at the backbone's pitch, its padded
    # columns zero like the backbone's
    msg = _msg_feature_from(fp, cfg, x01, plain, feat.shape[1] if off is None else None)
    if off is None:
        return feat + msg
    F = msg.shape[-1]
    return torch.cat([feat[:, :off], feat[:, off:off + F] + msg, feat[:, off + F:]], dim=1)


def wtmk_density(fp, cfg: WatermarkConfig, x, plain=False):
    """x [M, 3] -> dict(sigma [M], geo_feat [M, 15])."""
    feat = _encode_with_message(fp, cfg, x, plain)
    if plain:
        sigma, geo, _ = field_heads_plain(fp, cfg.ngp, feat)
    else:
        sigma, geo, _ = field_heads(fp, cfg.ngp, feat, want_geo=True)
    return {"sigma": sigma, "geo_feat": geo}


def wtmk_field(fp, cfg: WatermarkConfig, x, d, plain=False):
    """Fused forward (sigma [M], rgb [M, 3]) through K1 (twice), K9's table
    and K4; ``plain=True`` runs the plain versions whatever the device."""
    feat = _encode_with_message(fp, cfg, x, plain)
    heads = field_heads_plain if plain else field_heads
    sigma, _, rgb = heads(fp, cfg.ngp, feat, d)
    return sigma, rgb
