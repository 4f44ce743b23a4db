"""Clean instant-NGP field (counterpart of ``nerf_signature_tpu/models/ngp.py``).

positions in [-bound, bound] -> [0, 1] -> 16-level hash encoding (K1) ->
sigma MLP 32 -> 64 -> (1 + 15), sigma = trunc_exp(h[0]) -> SH degree 4 of
the direction, concatenated with the 15 geo features -> colour MLP
31 -> 64 -> 64 -> 3 -> sigmoid.  The two heads run fused in one kernel (K4,
``field_heads``), forward and backward: on the tensor cores in bf16
(``csrc/field_mma*.cu``), on the SIMT units in fp32 (``csrc/field.cu``,
``csrc/field_bwd.cu``, ``csrc/field_feat.cu``).

With ``bg_radius > 0`` the background-sphere model colours each ray's
background (``ngp_background``: the 2D encoding of the ray's exit point on
the sphere, SH of the direction, ``bg_net``, a sigmoid), as JAX completes
the reference's missing ``bg_net``; on the card all of it is K8, one kernel
forward and one backward (``ops/background.py``).

Params are a plain dict, laid out like the JAX tree: ``hash_table``
[rows, F] fp32, ``sigma_net`` / ``color_net`` lists of ``[in, out]`` fp32
weights, and with the background model ``bg_table`` [4 * 2^15, F] and
``bg_net``.  ``field_params`` adds what a render computes once and reuses for
every chunk: the table cast to the gather dtype, the MLP weights packed
into one flat buffer and, for the tensor-core kernels, into their bf16
layout (``mma_layout``).
"""

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..ops import _cuda
from ..ops.activation import trunc_exp
from ..ops.background import (
    BackgroundFn,
    BgMeta,
    background_plain,
    check_bg_buffers,
    check_bg_geometry,
    pack_bg_net,
)
from ..ops.hashenc import (
    KERNEL_FEATURES,
    KERNEL_MAX_LEVELS,
    hash_encode,
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
    table in the gather dtype, cast once; ``bg_table_g`` likewise with the
    background model), ``mlp_flat`` (all MLP weights in
    one fp32 buffer at K4's built widths, the SIMT kernels' layout) and, in
    bf16 on the card, ``mlp_mma`` (the tensor-core kernels' packed bf16
    weights).  Where K4 runs an encoding width W at a wider built input
    width IN of the dtype's route (24 at 32, 48 at 64, 96 at 128 in bf16),
    ``mlp_flat``'s Ws0 has IN rows, the last IN - W zero: the same
    ``torch.cat`` appends them, and its backward drops their gradients on
    the way to ``sigma_net[0]``."""
    table = params["hash_table"]
    gd = cfg.compute_dtype
    out = dict(params)
    out["hash_table_g"] = table.detach().to(gd) if gd != table.dtype else table.detach()
    nets = list(params["sigma_net"]) + list(params["color_net"])
    ws0 = nets[0]
    built = _built_widths((ws0.shape[0], ws0.shape[1], nets[1].shape[1], nets[2].shape[1]), gd)
    pad = [] if built is None or built[0] == ws0.shape[0] else [
        ws0.new_zeros(((built[0] - ws0.shape[0]) * ws0.shape[1],))]
    out["mlp_flat"] = torch.cat([ws0.reshape(-1)] + pad + [w.reshape(-1) for w in nets[1:]])
    if "bg_table" in params:
        out.update(bg_params(params, cfg))
    if _tensor_cores(cfg) and table.is_cuda:
        out["mlp_mma"] = pack_mlp_mma(out["mlp_flat"].detach(),
                                      _kernel_widths(params, cfg)).to(torch.bfloat16)
    return out


def _tensor_cores(cfg: NGPConfig):
    """The route of K4's forward, full backward and feature-only backward on
    the card, by the dtype alone: the tensor-core kernels
    (``csrc/field_mma*.cu``) in bf16, the SIMT ones (``csrc/field.cu``,
    ``csrc/field_bwd.cu``, ``csrc/field_feat.cu``) in fp32."""
    return cfg.compute_dtype == torch.bfloat16


def _mma_ld(n):
    """Row stride (elements) of an n-column bf16 matrix in the tensor-core
    kernels' shared memory: an odd number of 16-byte units, so the 8 rows an
    ``ldmatrix`` reads fall in distinct banks (``pad_ld`` in field_mma.cu)."""
    return n + 8 if (n // 8) % 2 == 0 else n


def mma_layout(widths):
    """The tensor-core kernels' weight buffer, in order: (name, rows, cols,
    row stride) of each ``[in, out]`` matrix.  ``s0`` is Ws0 with IN padded
    to 16 rows; ``c0`` is Wc0' [SH + OUT1, HC]: SH's 16 rows, a zero row 16
    facing o[0], then Wc0's rows 16-30 facing o[1:], so the colour input is
    [SH, o] whole; ``c2`` pads the 3 outputs to 8.  Padding is zero."""
    in_dim, hidden, out1, hc = widths
    return [("s0", max(in_dim, 16), hidden, _mma_ld(hidden)),
            ("s1", hidden, out1, _mma_ld(out1)),
            ("c0", 16 + out1, hc, _mma_ld(hc)),
            ("c1", hc, hc, _mma_ld(hc)),
            ("c2", hc, 8, _mma_ld(8))]


@functools.lru_cache(maxsize=None)
def _mma_source_index(widths, device):
    """For each element of the packed buffer, its index in ``mlp_flat``, or
    ``n_weights`` (a zero appended to it) for the padding and Wc0' row 16."""
    in_dim, hidden, out1, hc = widths
    shapes = [(in_dim, hidden), (hidden, out1), (16 + out1 - 1, hc), (hc, hc), (hc, 3)]
    offsets = np.cumsum([0] + [k * n for k, n in shapes])
    parts = []
    for (name, rows, _, ld), (k_src, n_src), off in zip(mma_layout(widths), shapes, offsets):
        idx = np.full((rows, ld), offsets[-1], np.int64)
        for r in range(rows):
            src = r - 1 if name == "c0" and r > 16 else r
            if (name == "c0" and r == 16) or src >= k_src:
                continue
            idx[r, :n_src] = off + src * n_src + np.arange(n_src)
        parts.append(idx.reshape(-1))
    return torch.from_numpy(np.concatenate(parts)).to(device)


def _n_weights(widths):
    in_dim, hidden, out1, hc = widths
    return in_dim * hidden + hidden * out1 + (16 + out1 - 1) * hc + hc * hc + hc * 3


@functools.lru_cache(maxsize=None)
def _mma_grad_index(widths, device):
    """For each element of ``mlp_flat``, its position in the packed buffer:
    the inverse of ``_mma_source_index``, int32.  The tensor-core backward
    sums the weight gradient in the packed layout and reads it back through
    this index, so Wc0' row 16 and the padding get no gradient."""
    src = _mma_source_index(widths, torch.device("cpu"))
    n_w = _n_weights(widths)
    keep = src < n_w
    index = torch.empty(n_w, dtype=torch.int64)
    index[src[keep]] = torch.nonzero(keep).reshape(-1)
    return index.to(torch.int32).to(device)


def mma_grad_to_flat(g_packed, widths):
    """A gradient in the packed layout (``mma_layout``) -> ``mlp_flat``
    order: the adjoint of ``pack_mlp_mma`` (Wc0' row 16 and the padding
    are dropped).  The plain version of the tensor-core backward's reduce."""
    return g_packed[_mma_grad_index(tuple(widths), g_packed.device).long()]


def pack_mlp_mma(flat, widths):
    """``mlp_flat`` -> the tensor-core kernels' layout (``mma_layout``), in
    flat's dtype; the kernels take it in bf16 (``field_params`` rounds it
    once, as ``mlp_apply``'s ``w.astype(bf16)`` does)."""
    idx = _mma_source_index(tuple(widths), flat.device)
    return torch.nn.functional.pad(flat, (0, 1))[idx]


def feature_pitch(cfg: NGPConfig):
    """The row width of the hash features K4 reads on the card: its built
    input width on cfg's route for cfg's encoding width (the columns past
    ``enc_dim`` zero), or ``enc_dim`` where K4 lacks one."""
    built = _built_widths(_cfg_widths(cfg), cfg.compute_dtype)
    return cfg.enc_dim if built is None else built[0]


def _encode_pos(params, cfg: NGPConfig, x, plain=False):
    """x in [-bound, bound] -> hash features (K1, or its plain version when
    ``plain``), differentiable in the master table; the rows are gathered in
    the compute dtype.  [M, enc_dim], or on the kernel path [M,
    feature_pitch(cfg)] (K1 writes the padded columns as zeros)."""
    bound = torch.full((), cfg.bound, dtype=torch.float32, device=x.device)
    x01 = (x + bound) / (2.0 * bound)
    return hash_encode(
        x01, params["hash_table"], cfg.resolutions, cfg.log2_hashmap_size,
        gather_dtype=cfg.compute_dtype, dense_sides=cfg.dense_sides,
        table_g=params.get("hash_table_g"),
        stochastic_grad=cfg.stochastic_hash_grad,
        level_stride=cfg.hash_level_stride, fwd_corners=cfg.hash_fwd_corners,
        plain=plain, pitch=None if plain or not x.is_cuda else feature_pitch(cfg),
    )


def ngp_color(params, cfg: NGPConfig, d, geo_feat):
    """dirs [M, 3] + geo_feat [M, 15] -> rgb [M, 3] (plain)."""
    sh = sh_encode(d, cfg.sh_degree)
    h = mlp_apply(params["color_net"], torch.cat([sh, geo_feat], dim=-1),
                  compute_dtype=cfg.compute_dtype)
    return torch.sigmoid(h)


def field_heads_plain(params, cfg: NGPConfig, feat, dirs=None, want_raw=False):
    """Plain version of K4: (sigma [M], geo_feat [M, G], rgb [M, 3] or None),
    and with ``want_raw`` the density logit h[..., 0] [M] fp32 fourth."""
    h = mlp_apply(params["sigma_net"], feat, compute_dtype=cfg.compute_dtype)
    sigma, geo = trunc_exp(h[..., 0]), h[..., 1:]
    rgb = None if dirs is None else ngp_color(params, cfg, dirs, geo)
    return (sigma, geo, rgb, h[..., 0]) if want_raw else (sigma, geo, rgb)


GEOMETRY_TODO = ("ROADMAP queue 3 item 'table geometries on the card with an encoding width "
                 "above 64 in fp32 (without -O) or above 128, rows of F not in {1, 2, 4, 8} or "
                 "more than 32 levels'")


def _cfg_widths(cfg: NGPConfig):
    return (cfg.enc_dim, cfg.hidden_dim, 1 + cfg.geo_feat_dim, cfg.hidden_dim_color)


def _route_widths(dtype):
    """K4's built widths on the dtype's route: the tensor-core kernels'
    (``MMA_WIDTHS``, up to IN = 128) in bf16, the SIMT kernels'
    (``FIELD_WIDTHS``, up to 64) otherwise."""
    return _cuda.MMA_WIDTHS if dtype == torch.bfloat16 else _cuda.FIELD_WIDTHS


def _built_widths(widths, dtype):
    """The K4 build (IN, hidden, 1 + geo, colour hidden) on the route of
    ``dtype`` that runs a field of these widths: the same hidden widths and
    the smallest built input width IN >= W (the features and Ws0
    zero-padded from W to IN), or None."""
    w, rest = widths[0], tuple(widths[1:])
    ins = [b[0] for b in _route_widths(dtype) if b[1:] == rest and b[0] >= w]
    return (min(ins),) + rest if ins else None


def _check_field(widths, dtype, sh_degree, layers, n_features=None, n_levels=None,
                 geometry=""):
    """The one rule of what the card's field kernels run: K4's hidden widths
    built on the route of ``dtype`` with an input width at least the
    encoding width (``_built_widths``: up to 128 in bf16, 64 in fp32) with
    SH degree 4, a 2-layer sigma MLP and a 3-layer colour MLP, and, where
    given, K1's rows of ``n_features`` in KERNEL_FEATURES and at most
    KERNEL_MAX_LEVELS levels.  Returns the built widths; raises naming the
    ROADMAP item."""
    built = _built_widths(widths, dtype)
    if (built is not None and (sh_degree, *layers) == (4, 2, 3)
            and n_features in (None, *KERNEL_FEATURES)
            and (n_levels is None or n_levels <= KERNEL_MAX_LEVELS)):
        return built
    bf16 = dtype == torch.bfloat16
    route = "bf16 (-O), on the tensor cores" if bf16 else "fp32, on the SIMT units"
    hint = "" if bf16 or _built_widths(widths, torch.bfloat16) is None else (
        "; -O (bf16) runs this width")
    raise NotImplementedError(
        f"the card's field kernels do not run {geometry}MLP widths {widths}, SH degree "
        f"{sh_degree}, {layers[0]} + {layers[1]} layers in {route}, yet ({GEOMETRY_TODO}; "
        f"K1 takes rows of F in {KERNEL_FEATURES} features at up to {KERNEL_MAX_LEVELS} "
        f"levels, K4 in {route[:4]} an encoding width up to the built widths "
        f"{_route_widths(dtype)} with SH degree 4, a 2-layer sigma MLP and a 3-layer colour "
        f"MLP{hint}); on the CPU (--cpu, device='cpu') every geometry runs through the plain "
        f"versions")


def check_kernel_geometry(cfg: NGPConfig):
    """Refuse up front, before a model is built on the card, a config
    whose field the kernels cannot run: a row width F that K1 lacks, more
    levels than it takes, or an encoding width (n_levels x F) above K4's
    widest build on cfg's route: 128 in bf16 (32 x 8 is refused), 64 in
    fp32 (16 x 8 without -O is); and, with the bg model, a ``bg_net`` other
    than IN -> 64 -> 3 (2 layers) or more than 32 bg levels (K8's build)."""
    _check_field(_cfg_widths(cfg), cfg.compute_dtype, cfg.sh_degree,
                 (cfg.num_layers, cfg.num_layers_color), cfg.n_features, cfg.n_levels,
                 f"{cfg.n_levels} levels x {cfg.n_features} features, ")
    if cfg.bg_radius > 0:
        check_bg_geometry(cfg.bg_n_levels, cfg.n_features, cfg.bg_hidden_dim,
                          cfg.bg_num_layers, cfg.sh_degree)


def _kernel_widths(params, cfg: NGPConfig):
    """K4's built widths (IN, hidden, 1 + geo, colour hidden) on cfg's
    route for the widths read from the params (an encoding width W runs at
    the smallest built IN >= W); raises where the kernels lack them
    (``_check_field``)."""
    if cfg.compute_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"compute dtype {cfg.compute_dtype}")
    s, c = params["sigma_net"], params["color_net"]
    widths = (s[0].shape[0], s[0].shape[1], s[-1].shape[1], c[0].shape[1])
    return _check_field(widths, cfg.compute_dtype, cfg.sh_degree, (len(s), len(c)))


def field_heads(params, cfg: NGPConfig, feat, dirs=None, want_geo=False, want_raw=False):
    """K4: fused sigma head, SH, colour head.  feat [M, enc_dim] fp32 (on the
    card [M, IN] at K4's built input width, ``feature_pitch``),
    dirs [M, 3] or None (no colour).  Returns (sigma [M], geo [M, G] or None,
    rgb [M, 3] or None); geo is returned when ``want_geo`` (always on the
    plain path).  With ``want_raw`` a fourth output, the density logit
    h[..., 0] [M] fp32 before ``trunc_exp`` (the CopyRNeRF MLP's input),
    which the kernels write beside sigma (counted as ``K4_field_raw``; never
    ``log(sigma)``, which is -inf where exp underflows).  Under autograd
    (training) the CUDA path is ``FieldHeadsFn`` (``FieldHeadsRawFn`` with
    the logit), whose backward is the K4 backward kernel; the CPU path is
    autograd through ``field_heads_plain``."""
    if not feat.is_cuda:
        return field_heads_plain(params, cfg, feat, dirs, want_raw)
    nets = list(params["sigma_net"]) + list(params["color_net"])
    if params.get("mlp_flat") is None:
        params = field_params(params, cfg)
    flat, mma = params["mlp_flat"], params.get("mlp_mma")
    widths = _kernel_widths(params, cfg)
    if _cuda.needs_grad(feat, flat, *nets):
        if dirs is None or want_geo:
            raise NotImplementedError(
                "the field kernel's backward takes the (sigma, rgb) heads of a "
                "train step; geo features and density-only queries run without "
                "grad")
        if want_raw:
            sigma, rgb, raw = FieldHeadsRawFn.apply(feat, dirs, flat, mma, cfg, widths)
            return sigma, None, rgb, raw
        sigma, rgb = FieldHeadsFn.apply(feat, dirs, flat, mma, cfg, widths)
        return sigma, None, rgb
    out = _field_heads_kernel(cfg, flat, feat, dirs, want_geo, widths, mma, want_raw)
    return out if want_raw else out[:3]


def _mma_weights(flat, mma, widths, dev):
    """The tensor-core kernels' packed bf16 weights: ``mma`` as
    ``field_params`` made it, or packed from ``flat`` now."""
    if mma is None:
        mma = pack_mlp_mma(flat.detach(), widths).to(torch.bfloat16)
    n = sum(rows * ld for _, rows, _, ld in mma_layout(widths))
    _cuda.check(mma, "mlp_mma", torch.bfloat16, (n,), dev)
    if mma.data_ptr() % 16:
        raise ValueError("mlp_mma: must be 16-byte aligned")
    return mma


# K4's tiled SIMT kernels (fp32): samples a tile, which is also threads a
# block, and blocks an SM of the persistent grid.  The forward
# (csrc/field.cu:field_fwd) fits two blocks an SM, the feature-only
# backward (csrc/field_feat.cu) and the full one (csrc/field_bwd.cu) one;
# the tiles are NGP_FWD_T, NGP_BWD_FEAT_T and NGP_BWD_T there.  The full
# backward's rows are BWD_LD floats apart and it scans BWD_ROUND chunks
# of a tile's samples a round (NGP_BWD_LD, NGP_BWD_U)
SIMT_TILE = {"fwd": 128, "bwd_feat": 256, "bwd": 128}
SIMT_BLOCKS_PER_SM = {"fwd": 2, "bwd_feat": 1, "bwd": 1}
BWD_LD = 132
BWD_ROUND = 4


def simt_launch(widths, kind, M=0, sms=1):
    """Threads, dynamic shared-memory bytes and blocks of K4's SIMT
    ``kind`` ("fwd", "bwd_feat" or "bwd") at ``widths`` for M samples on
    ``sms`` SMs, as the sources lay the memory out (the launchers refuse
    any other size).  "fwd" and "bwd_feat" (``csrc/field_common.cuh:
    SimtDims``): two activation buffers of max(IN, HID, HC, CIN) rows of a
    tile's samples, the weights, and for the backward its transposed
    weights, one 64-bit ReLU mask a sample and its queue of live samples.
    "bwd" (``csrc/field_bwd.cu:BwdDims``): three activation buffers of
    max(IN, HID, HC, 32) rows of BWD_LD floats, gc3's 4 rows, the weights
    and their transposes, a queue of (BWD_ROUND + 1) tiles of int32 sample
    numbers and a ballot a warp for each chunk of a round."""
    in_dim, hidden, out1, hc = widths
    cin = 16 + out1 - 1  # SH4 and geo
    tile = SIMT_TILE[kind]
    n_wt = hc * hc + hc * out1 + out1 * hidden + hidden * in_dim  # the transposes
    if kind == "bwd":
        rows = max(in_dim, hidden, hc, 32)
        smem = 4 * (3 * rows * BWD_LD + 4 * BWD_LD + _n_weights(widths) + n_wt)
        smem += 4 * (BWD_ROUND + 1) * tile + 4 * BWD_ROUND * (tile // 32)
    else:
        smem = 4 * (2 * max(in_dim, hidden, hc, cin) * tile + _n_weights(widths))
        if kind == "bwd_feat":
            # the transposed weights, the ReLU masks, the queue of live
            # samples and 16 ints of scratch
            smem += 4 * n_wt + 8 * tile + 8 * 2 * tile + 4 * 16
    blocks = max(1, min(-(-M // tile), SIMT_BLOCKS_PER_SM[kind] * sms))
    return tile, smem, blocks


# What dynamic shared memory an H100 SM holds (each block reserving 1 KB
# besides) and the most one block may opt in to: K4's tensor-core plans are
# chosen by what fits (csrc/field_mma.cuh:SM_SMEM, BLOCK_RESERVED,
# MAX_BLOCK_SMEM)
SM_SMEM, BLOCK_RESERVED, MAX_BLOCK_SMEM = 233_472, 1_024, 232_448


def _mma_smem(widths, kind, rt, warps):
    """Dynamic shared bytes of K4's tensor-core ``kind`` at ``rt`` 16-row
    tiles a warp and ``warps`` warps a block, as the sources lay the memory
    out: the packed bf16 weights (``mma_layout``), then for "fwd" and
    "bwd_feat" (``csrc/field_mma.cuh:MmaDims``) each warp's two fp32
    feature tiles at a row stride of IN + 8 floats (8 at IN = 8), and for
    "bwd" (``csrc/field_mma_bwd_full.cu:FullPlan``) the block's fp32 weight
    gradient in the packed layout, the bf16 staging of each layer's input
    activation and output cotangent for 16 samples a warp, and two vote
    words a warp."""
    in_dim, hidden, out1, hc = widths
    n_pack = sum(rows * ld for _, rows, _, ld in mma_layout(widths))
    if kind == "bwd":
        units = [max(in_dim, 16), hidden, 16 + out1, hc, hc] + [hidden, out1, hc, hc, 8]
        return 6 * n_pack + 2 * 16 * warps * sum(_mma_ld(u) for u in units) + 8 * warps
    fld = in_dim if in_dim == 8 else in_dim + 8
    return 2 * n_pack + warps * 2 * 16 * rt * fld * 4


def mma_launch(widths, kind):
    """Threads a block and dynamic shared bytes of K4's tensor-core
    ``kind`` ("fwd", "bwd_feat" or "bwd") at built ``widths``, the plan
    chosen as the sources choose it (``csrc/field_mma.cuh:FwdDims``,
    ``BwdDims``; ``csrc/field_mma_bwd_full.cu:FullDims``): 4 warps a block,
    the forward carrying two 16-row tiles a warp while two such blocks fit
    an SM and one past that, the feature-only backward one; the full
    backward 8 warps a block while that fits a block, else 4.  The
    launchers refuse any other size; ``ops/_cuda.py:mma_plan`` reads the
    compiled plan on the card."""
    if kind == "bwd":
        warps = 8 if _mma_smem(widths, kind, 1, 8) <= MAX_BLOCK_SMEM else 4
        return 32 * warps, _mma_smem(widths, kind, 1, warps)
    two_fit = SM_SMEM // (_mma_smem(widths, "fwd", 2, 4) + BLOCK_RESERVED) >= 2
    return 128, _mma_smem(widths, kind, 2 if kind == "fwd" and two_fit else 1, 4)


def _field_heads_kernel(cfg, flat, feat, dirs, want_geo, widths, mma=None, want_raw=False):
    in_dim, hidden, out1, hidden_c = widths
    M = feat.shape[0]
    dev = feat.device
    _cuda.check(feat, "feat", torch.float32, (M, in_dim), dev)
    _cuda.check(flat, "mlp_flat", torch.float32, (_n_weights(widths),), dev)
    if dirs is not None:
        _cuda.check(dirs, "dirs", torch.float32, (M, 3), dev)
    sigma = torch.empty((M,), dtype=torch.float32, device=dev)
    geo = torch.empty((M, out1 - 1), dtype=torch.float32, device=dev) if want_geo else None
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev) if dirs is not None else None
    raw = torch.empty((M,), dtype=torch.float32, device=dev) if want_raw else None
    outs = (sigma.data_ptr(), _cuda.ptr(geo), _cuda.ptr(rgb)) + ((raw.data_ptr(),) if want_raw
                                                                 else ())
    outs += (M, in_dim, hidden, out1, hidden_c)
    if _tensor_cores(cfg):
        mma = _mma_weights(flat, mma, widths, dev)
        kernel = _cuda.FIELD_MMA_RAW if want_raw else _cuda.FIELD_MMA
        kernel(feat.data_ptr(), _cuda.ptr(dirs), mma.data_ptr(), *outs,
               mma_launch(widths, "fwd")[1])
    else:  # fp32: the tiled SIMT kernel, a persistent grid
        _, smem, blocks = simt_launch(widths, "fwd", M, _cuda.sm_count(dev))
        kernel = _cuda.FIELD_RAW if want_raw else _cuda.FIELD
        kernel(feat.data_ptr(), _cuda.ptr(dirs), flat.data_ptr(), *outs, blocks, smem)
    return sigma, geo, rgb, raw


class FieldHeadsFn(torch.autograd.Function):
    """K4 forward and backward: (feat [M, IN], dirs [M, 3], mlp_flat, the
    packed bf16 weights or None, cfg, widths) -> (sigma [M], rgb [M, 3]);
    gradients to feat and mlp_flat, or to feat alone (the feature-only
    kernel) when mlp_flat needs none."""

    @staticmethod
    def forward(ctx, feat, dirs, flat, mma, cfg, widths):
        sigma, _, rgb, _ = _field_heads_kernel(cfg, flat, feat, dirs, False, widths, mma)
        ctx.save_for_backward(feat, dirs, flat, mma)
        ctx.cfg, ctx.widths = cfg, widths
        return sigma, rgb

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        feat, dirs, flat, mma = ctx.saved_tensors
        return _field_heads_vjp(ctx, feat, dirs, flat, mma, g_sigma, g_rgb) + (None,)


class FieldHeadsRawFn(torch.autograd.Function):
    """``FieldHeadsFn`` with the density logit h0 [M] as a third output.
    Its cotangent joins sigma's before the backward kernel, which takes
    ``g_sigma * exp(clip(h0, -15, 15))`` as h0's: ``g_sigma + g_raw *
    exp(-clip(h0, -15, 15))`` gives h0 both (to a few ulps; the clip keeps
    the factor finite)."""

    @staticmethod
    def forward(ctx, feat, dirs, flat, mma, cfg, widths):
        sigma, _, rgb, raw = _field_heads_kernel(cfg, flat, feat, dirs, False, widths, mma,
                                                 want_raw=True)
        ctx.save_for_backward(feat, dirs, flat, mma, raw)
        ctx.cfg, ctx.widths = cfg, widths
        return sigma, rgb, raw

    @staticmethod
    def backward(ctx, g_sigma, g_rgb, g_raw):
        feat, dirs, flat, mma, raw = ctx.saved_tensors
        g_sigma = g_sigma + g_raw * torch.exp(-torch.clamp(raw, -15.0, 15.0))
        return _field_heads_vjp(ctx, feat, dirs, flat, mma, g_sigma, g_rgb)


def _field_heads_vjp(ctx, feat, dirs, flat, mma, g_sigma, g_rgb):
    """The cotangents of FieldHeadsFn's six inputs, from K4's backward."""
    args = (ctx.cfg, ctx.widths, feat, dirs, flat, g_sigma.contiguous(), g_rgb.contiguous())
    if not ctx.needs_input_grad[2]:
        # frozen weights (the watermark stage's backbone): g_feat only
        return field_heads_bwd_feat(*args, mma), None, None, None, None, None
    g_feat, g_flat = field_heads_bwd(*args, mma)
    return g_feat, None, g_flat, None, None, None


def field_heads_bwd_feat(cfg, widths, feat, dirs, flat, g_sigma, g_rgb, mma=None):
    """The feature-only K4 backward kernel: g_feat [M, IN] fp32 from the
    cotangents of sigma [M] and rgb [M, 3], no weight gradient (the weights
    are frozen).  In fp32 the SIMT kernel, equal to ``field_heads_bwd``'s
    g_feat bit for bit; in bf16 the tensor-core kernel, which rounds at the
    same points but sums each product in another order."""
    in_dim, hidden, out1, hidden_c = widths
    M = feat.shape[0]
    dev = feat.device
    _cuda.check(feat, "feat", torch.float32, (M, in_dim), dev)
    _cuda.check(dirs, "dirs", torch.float32, (M, 3), dev)
    _cuda.check(flat, "mlp_flat", torch.float32, (_n_weights(widths),), dev)
    _cuda.check(g_sigma, "g_sigma", torch.float32, (M,), dev)
    _cuda.check(g_rgb, "g_rgb", torch.float32, (M, 3), dev)
    g_feat = torch.empty((M, in_dim), dtype=torch.float32, device=dev)
    args = (g_sigma.data_ptr(), g_rgb.data_ptr(), g_feat.data_ptr(), M, in_dim, hidden, out1,
            hidden_c)
    if _tensor_cores(cfg):
        mma = _mma_weights(flat, mma, widths, dev)
        _cuda.FIELD_BWD_FEAT_MMA(feat.data_ptr(), dirs.data_ptr(), mma.data_ptr(), *args,
                                 mma_launch(widths, "bwd_feat")[1])
    else:  # fp32: the tiled SIMT kernel, a persistent grid taking chunks from a counter
        _, smem, blocks = simt_launch(widths, "bwd_feat", M, _cuda.sm_count(dev))
        next_chunk = torch.zeros((1,), dtype=torch.int32, device=dev)
        _cuda.FIELD_BWD_FEAT(feat.data_ptr(), dirs.data_ptr(), flat.data_ptr(), *args,
                             next_chunk.data_ptr(), blocks, smem)
    return g_feat


def field_heads_bwd(cfg, widths, feat, dirs, flat, g_sigma, g_rgb, mma=None):
    """The K4 backward kernel: (g_feat [M, IN], g_flat [n_weights]), both
    fp32, from the cotangents of sigma [M] and rgb [M, 3].  In bf16 the
    tensor-core kernel on the packed weights (``mma``, or packed from
    ``flat`` now), which recomputes the forward with the forward kernel's
    fragments; in fp32 the tiled SIMT one on the live samples.  Either sums
    the weight gradient in per-block partials, one block an SM, each block
    over a fixed share of the samples, reduced in block order
    (deterministic on a given grid)."""
    in_dim, hidden, out1, hidden_c = widths
    M = feat.shape[0]
    dev = feat.device
    _cuda.check(feat, "feat", torch.float32, (M, in_dim), dev)
    _cuda.check(dirs, "dirs", torch.float32, (M, 3), dev)
    _cuda.check(flat, "mlp_flat", torch.float32, (_n_weights(widths),), dev)
    _cuda.check(g_sigma, "g_sigma", torch.float32, (M,), dev)
    _cuda.check(g_rgb, "g_rgb", torch.float32, (M, 3), dev)
    g_feat = torch.empty((M, in_dim), dtype=torch.float32, device=dev)
    g_flat = torch.empty_like(flat)
    sms = _cuda.sm_count(dev)
    if _tensor_cores(cfg):
        mma = _mma_weights(flat, mma, widths, dev)
        if feat.data_ptr() % 8:
            raise ValueError("feat: must be 8-byte aligned")
        # one block an SM (mma_launch), each walking chunks of 512 samples
        n_blocks = max(1, min(-(-M // 512), sms))
        partials = torch.empty((n_blocks, mma.numel()), dtype=torch.float32, device=dev)
        _cuda.FIELD_BWD_MMA(feat.data_ptr(), dirs.data_ptr(), mma.data_ptr(), g_sigma.data_ptr(),
                            g_rgb.data_ptr(), g_feat.data_ptr(), partials.data_ptr(),
                            _mma_grad_index(tuple(widths), dev).data_ptr(), g_flat.data_ptr(),
                            M, n_blocks, in_dim, hidden, out1, hidden_c,
                            mma_launch(widths, "bwd")[1])
    else:  # fp32: the tiled SIMT kernel over queued live samples, one block an SM
        _, smem, n_blocks = simt_launch(widths, "bwd", M, sms)
        partials = torch.empty((n_blocks, flat.numel()), dtype=torch.float32, device=dev)
        _cuda.FIELD_BWD(feat.data_ptr(), dirs.data_ptr(), flat.data_ptr(), g_sigma.data_ptr(),
                        g_rgb.data_ptr(), g_feat.data_ptr(), partials.data_ptr(),
                        g_flat.data_ptr(), M, n_blocks, in_dim, hidden, out1, hidden_c, smem)
    return g_feat, g_flat


def ngp_density(params, cfg: NGPConfig, x):
    """x: [M, 3] in [-bound, bound] -> dict(sigma [M], geo_feat [M, 15])."""
    sigma, geo, _ = field_heads(params, cfg, _encode_pos(params, cfg, x), want_geo=True)
    return {"sigma": sigma, "geo_feat": geo}


def ngp_field(params, cfg: NGPConfig, x, d, plain=False):
    """Fused forward: (sigma [M], rgb [M, 3]).  ``plain=True`` runs the plain
    versions of K1 and K4 whatever the device (how the kernels are held
    against them on the card)."""
    feat = _encode_pos(params, cfg, x, plain)
    heads = field_heads_plain if plain else field_heads
    sigma, _, rgb = heads(params, cfg, feat, d)
    return sigma, rgb


@functools.lru_cache(maxsize=None)
def bg_meta(cfg: NGPConfig) -> BgMeta:
    """The bg model's static geometry (built once a config)."""
    return BgMeta(cfg.bg_resolutions, cfg.bg_log2_hashmap_size, float(cfg.bg_radius),
                  cfg.compute_dtype, cfg.sh_degree)


def bg_params(params, cfg: NGPConfig):
    """The background model's leaves of ``params`` (``bg_table``,
    ``bg_net``), ``bg_table_g``, the table in the gather dtype, and on the
    card ``bg_packed``, bg_net's weights packed and rounded to the compute
    dtype (``ops/background.py:pack_bg_net``), each made once per render or
    step and validated here, not at every call of the kernels."""
    table = params["bg_table"]
    gd = cfg.compute_dtype
    out = {"bg_table": table, "bg_net": params["bg_net"],
           "bg_table_g": table.detach().to(gd) if gd != table.dtype else table.detach()}
    if table.is_cuda:
        out["bg_packed"] = pack_bg_net(params["bg_net"], gd)
        check_bg_buffers(out["bg_table_g"], out["bg_packed"], bg_meta(cfg))
    return out


def ngp_background(params, cfg: NGPConfig, rays_o, rays_d, plain=False):
    """Per-ray background colour of the bg-sphere model: rays [N, 3] -> rgb
    [N, 3] in [0, 1].  The 2D encoding of each ray's exit point on the
    sphere of ``cfg.bg_radius``, concatenated with the SH of the normalised
    direction, through ``bg_net`` ([4F + 16 -> 64 -> 3]) and a sigmoid.  On
    the card one kernel forward and one backward (``BackgroundFn``); with
    ``plain`` or on CPU tensors the chain of torch ops that is their plain
    version (``background_plain``), differentiated by autograd."""
    if plain or not rays_o.is_cuda:
        table_g = params.get("bg_table_g")
        return background_plain(rays_o, rays_d, params["bg_table"], params["bg_net"],
                                bg_meta(cfg), table_g)
    if params.get("bg_packed") is None:
        params = bg_params(params, cfg)
    w1, w2 = params["bg_net"]
    return BackgroundFn.apply(rays_o, rays_d, params["bg_table"], w1, w2, params["bg_table_g"],
                              params["bg_packed"], bg_meta(cfg))


def background_fn(params, cfg: NGPConfig, plain=False):
    """The renderer's ``bg_fn(rays_o, rays_d)`` of the bg-sphere model on
    ``params`` (``field_params`` or ``bg_params``), or None without one
    (``bg_radius <= 0``)."""
    if cfg.bg_radius <= 0:
        return None
    return lambda o, d: ngp_background(params, cfg, o, d, plain=plain)
