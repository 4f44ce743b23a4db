"""Clean instant-NGP field (counterpart of ``nerf_signature_tpu/models/ngp.py``).

positions in [-bound, bound] -> [0, 1] -> 16-level hash encoding (K1) ->
sigma MLP 32 -> 64 -> (1 + 15), sigma = trunc_exp(h[0]) -> SH degree 4 of
the direction, concatenated with the 15 geo features -> colour MLP
31 -> 64 -> 64 -> 3 -> sigmoid.  The two heads run fused in one kernel (K4,
``field_heads``).

Params are a plain dict, laid out like the JAX tree: ``hash_table``
[rows, F] fp32, ``sigma_net`` / ``color_net`` lists of ``[in, out]`` fp32
weights.  ``field_params`` adds what a render computes once and reuses for
every chunk: the table cast to the gather dtype and the MLP weights packed
into one flat buffer for the kernel.
"""

import dataclasses
from typing import Any

import torch

from ..ops import _cuda
from ..ops.activation import trunc_exp
from ..ops.hashenc import (
    hash_encode,
    hash_encode_2d,
    hash_encode_plain,
    init_hash_table,
    init_hash_table_sized,
    level_resolutions,
    level_sides,
)
from ..ops.sh import sh_encode
from .mlp import init_mlp, mlp_apply


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    bound: float = 1.0
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = 2048
    hidden_dim: int = 64
    num_layers: int = 2
    geo_feat_dim: int = 15
    hidden_dim_color: int = 64
    num_layers_color: int = 3
    sh_degree: int = 4
    density_scale: float = 1.0
    compute_dtype: Any = torch.bfloat16
    stochastic_hash_grad: bool = False
    hash_level_stride: int = 1
    hash_fwd_corners: int = 8
    dense_coarse: bool = False
    bg_radius: float = -1.0
    bg_n_levels: int = 4
    bg_log2_hashmap_size: int = 15
    bg_base_resolution: int = 16
    bg_finest_resolution: int = 2048
    bg_hidden_dim: int = 64
    bg_num_layers: int = 2

    @property
    def resolutions(self):
        return tuple(level_resolutions(
            self.n_levels, self.base_resolution, self.finest_resolution).tolist())

    @property
    def dense_sides(self):
        if not self.dense_coarse:
            return None
        return level_sides(self.resolutions, self.log2_hashmap_size, True)

    @property
    def enc_dim(self):
        return self.n_levels * self.n_features

    @property
    def sh_dim(self):
        return self.sh_degree**2

    @property
    def bg_resolutions(self):
        return tuple(level_resolutions(
            self.bg_n_levels, self.bg_base_resolution,
            self.bg_finest_resolution).tolist())


def exact_field_cfg(cfg: NGPConfig) -> NGPConfig:
    """The exact 8-corner view of a config (every eval/render path)."""
    if cfg.hash_fwd_corners == 8:
        return cfg
    return dataclasses.replace(cfg, hash_fwd_corners=8)


def init_ngp_params(generator, cfg: NGPConfig, device="cpu"):
    """Random params from a ``torch.Generator`` (CPU), placed on ``device``."""
    sigma_dims = ([cfg.enc_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
                  + [1 + cfg.geo_feat_dim])
    color_dims = ([cfg.sh_dim + cfg.geo_feat_dim]
                  + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [3])
    if cfg.dense_coarse:
        table = init_hash_table_sized(generator, cfg.dense_sides, cfg.n_features,
                                      cfg.log2_hashmap_size, device)
    else:
        table = init_hash_table(generator, cfg.n_levels, cfg.n_features,
                                cfg.log2_hashmap_size, device)
    params = {
        "hash_table": table,
        "sigma_net": init_mlp(generator, sigma_dims, device),
        "color_net": init_mlp(generator, color_dims, device),
    }
    if cfg.bg_radius > 0:
        bg_dims = ([cfg.bg_n_levels * cfg.n_features + cfg.sh_dim]
                   + [cfg.bg_hidden_dim] * (cfg.bg_num_layers - 1) + [3])
        params["bg_table"] = init_hash_table(
            generator, cfg.bg_n_levels, cfg.n_features, cfg.bg_log2_hashmap_size,
            device)
        params["bg_net"] = init_mlp(generator, bg_dims, device)
    return params


def field_params(params, cfg: NGPConfig):
    """``params`` plus the per-render derived buffers: ``hash_table_g`` (the
    table in the gather dtype, cast once) and ``mlp_flat`` (all MLP weights
    in one fp32 buffer, the kernel's layout)."""
    table = params["hash_table"]
    gd = cfg.compute_dtype
    out = dict(params)
    out["hash_table_g"] = table.to(gd) if gd != table.dtype else table
    out["mlp_flat"] = torch.cat(
        [w.reshape(-1) for w in list(params["sigma_net"]) + list(params["color_net"])])
    return out


def _encode_pos(params, cfg: NGPConfig, x, plain=False):
    """x in [-bound, bound] -> hash features [M, enc_dim] (K1, or its plain
    version when ``plain``); the rows are gathered in the compute dtype."""
    bound = torch.tensor(cfg.bound, dtype=torch.float32, device=x.device)
    x01 = (x + bound) / (2.0 * bound)
    if plain:
        return hash_encode_plain(
            x01, params["hash_table"], cfg.resolutions, cfg.log2_hashmap_size,
            gather_dtype=cfg.compute_dtype, dense_sides=cfg.dense_sides,
            table_g=params.get("hash_table_g"))
    return hash_encode(
        x01, params["hash_table"], cfg.resolutions, cfg.log2_hashmap_size,
        gather_dtype=cfg.compute_dtype, dense_sides=cfg.dense_sides,
        table_g=params.get("hash_table_g"),
        stochastic_grad=cfg.stochastic_hash_grad,
        level_stride=cfg.hash_level_stride, fwd_corners=cfg.hash_fwd_corners,
    )


def _sigma_head(params, cfg: NGPConfig, feat):
    h = mlp_apply(params["sigma_net"], feat, compute_dtype=cfg.compute_dtype)
    return trunc_exp(h[..., 0]), h[..., 1:]


def ngp_color(params, cfg: NGPConfig, d, geo_feat):
    """dirs [M, 3] + geo_feat [M, 15] -> rgb [M, 3] (plain)."""
    sh = sh_encode(d, cfg.sh_degree)
    h = mlp_apply(params["color_net"], torch.cat([sh, geo_feat], dim=-1),
                  compute_dtype=cfg.compute_dtype)
    return torch.sigmoid(h)


def field_heads_plain(params, cfg: NGPConfig, feat, dirs=None):
    """Plain version of K4: (sigma [M], geo_feat [M, G], rgb [M, 3] or None)."""
    sigma, geo = _sigma_head(params, cfg, feat)
    rgb = None if dirs is None else ngp_color(params, cfg, dirs, geo)
    return sigma, geo, rgb


def _kernel_widths(params, cfg: NGPConfig):
    s, c = params["sigma_net"], params["color_net"]
    if cfg.sh_degree != 4 or len(s) != 2 or len(c) != 3:
        raise NotImplementedError(
            "the field kernel runs the default architecture only: SH degree 4, "
            "a 2-layer sigma MLP and a 3-layer colour MLP")
    widths = (s[0].shape[0], s[0].shape[1], s[1].shape[1], c[0].shape[1])
    if widths not in ((32, 64, 16, 64), (8, 16, 16, 16)) or c[1].shape[1] != widths[3]:
        raise NotImplementedError(
            f"the field kernel is built for widths (32, 64, 16, 64) and "
            f"(8, 16, 16, 16); got {widths}")
    if cfg.compute_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"compute dtype {cfg.compute_dtype}")
    return widths


def field_heads(params, cfg: NGPConfig, feat, dirs=None, want_geo=False):
    """K4: fused sigma head, SH, colour head.  feat [M, enc_dim] fp32,
    dirs [M, 3] or None (no colour).  Returns (sigma [M], geo [M, G] or None,
    rgb [M, 3] or None); geo is returned when ``want_geo`` (always on the
    plain path)."""
    if not feat.is_cuda:
        return field_heads_plain(params, cfg, feat, dirs)
    _cuda.no_grad_inputs("field_heads", feat, *params["sigma_net"], *params["color_net"])
    in_dim, hidden, out1, hidden_c = _kernel_widths(params, cfg)
    M = feat.shape[0]
    dev = feat.device
    flat = params.get("mlp_flat")
    if flat is None:
        flat = field_params(params, cfg)["mlp_flat"]
    _cuda.check(feat, "feat", torch.float32, (M, in_dim), dev)
    _cuda.check(flat, "mlp_flat", torch.float32, None, dev)
    if dirs is not None:
        _cuda.check(dirs, "dirs", torch.float32, (M, 3), dev)
    sigma = torch.empty((M,), dtype=torch.float32, device=dev)
    geo = torch.empty((M, out1 - 1), dtype=torch.float32, device=dev) if want_geo else None
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev) if dirs is not None else None
    _cuda.FIELD(feat.data_ptr(), _cuda.ptr(dirs), flat.data_ptr(), sigma.data_ptr(),
                _cuda.ptr(geo), _cuda.ptr(rgb), M, in_dim, hidden, out1, hidden_c,
                int(cfg.compute_dtype == torch.bfloat16))
    return sigma, geo, rgb


def ngp_density(params, cfg: NGPConfig, x):
    """x: [M, 3] in [-bound, bound] -> dict(sigma [M], geo_feat [M, 15])."""
    sigma, geo, _ = field_heads(params, cfg, _encode_pos(params, cfg, x),
                                want_geo=True)
    return {"sigma": sigma, "geo_feat": geo}


def ngp_field(params, cfg: NGPConfig, x, d, plain=False):
    """Fused forward: (sigma [M], rgb [M, 3]).  ``plain=True`` runs the plain
    versions of K1 and K4 whatever the device (how the kernels are held
    against them on the card)."""
    feat = _encode_pos(params, cfg, x, plain)
    heads = field_heads_plain if plain else field_heads
    sigma, _, rgb = heads(params, cfg, feat, d)
    return sigma, rgb


def ngp_background(params, cfg: NGPConfig, rays_o, rays_d):
    """The bg-sphere model needs the 2D hash encoder (K8)."""
    return hash_encode_2d()
