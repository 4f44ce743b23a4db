"""K8: the background colour of the bg-sphere model in one kernel forward
and one backward (``csrc/background.cu``).

Counterpart of ``nerf_signature_tpu/models/ngp.py:ngp_background``: each
ray's exit point on the sphere of ``radius`` (``ops/intersect.py:
sph_from_ray``), its L-level 2D hash encoding, concatenated with SH4 of the
normalised direction, through ``bg_net`` (IN -> 64 -> 3, ReLU, bias-free;
``models/mlp.py:mlp_apply``'s roundings in bf16) and a sigmoid.

``BackgroundFn`` is the kernel wrapper, differentiable in the fp32 master
table and both ``bg_net`` matrices: it launches ``bg_color_fwd`` and,
backward, ``bg_color_bwd`` and ``bg_finish``, or raises (a CPU tensor
included).  Their plain versions are ``background_plain`` (the chain of
torch ops the port ran before the kernels, which the tests hold against
JAX, and which ``models/ngp.py:ngp_background`` runs on CPU tensors) and
``background_bwd_plain`` (that chain's autograd written out, the kernel's
roundings step by step).
What a render or a step computes once (the table in the gather dtype, the
packed weights rounded to the compute dtype) comes in as tensors
(``models/ngp.py:bg_params``); the kernels' static arguments (levels,
r^2, the backward's tile) are cached by geometry (``kernel_args``).
"""

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda
from .hashenc import (
    KERNEL_FEATURES,
    KERNEL_MAX_LEVELS,
    bg_encode,
    hash_encode_2d_bwd_plain,
    hash_encode_2d_plain,
    sphere_x01,
)
from .sh import sh_encode

# the bg_net the kernels are built for: IN -> BG_HIDDEN -> 3, BG_LAYERS
# matrices, SH of degree BG_SH_DEGREE (16 inputs); the levels and row widths
# of K8's encoding (KERNEL_MAX_LEVELS, KERNEL_FEATURES)
BG_HIDDEN = 64
BG_LAYERS = 2
BG_SH_DEGREE = 4
# the backward's rays a tile (threads a block), the wider whose staging
# fits a block's shared memory (csrc/background.cu:bg_bwd_smem)
BWD_TILES = (128, 64)
SMEM_MAX = 232_448
BG_GEOMETRY_TODO = ("ROADMAP queue 3 item 'bg models on the card other than bg_net "
                    "IN -> 64 -> 3 with SH degree 4'")


class BgMeta(NamedTuple):
    """The background model's static geometry (hashable: the key of
    ``kernel_args``)."""
    resolutions: tuple
    log2_hashmap_size: int
    radius: float
    compute_dtype: torch.dtype
    sh_degree: int


class KernelArgs(NamedTuple):
    res: np.ndarray  # kept alive: res_ptr points into it
    res_ptr: object
    r2: float
    L: int
    F: int
    IN: int
    n_weights: int
    bf16: int
    tile: int


def check_bg_geometry(n_levels, n_features, hidden, layers, sh_degree):
    """Refuse a bg model the kernels are not built for (raises
    NotImplementedError naming the ROADMAP item)."""
    if (n_features in KERNEL_FEATURES and 1 <= n_levels <= KERNEL_MAX_LEVELS
            and (hidden, layers, sh_degree) == (BG_HIDDEN, BG_LAYERS, BG_SH_DEGREE)):
        return
    raise NotImplementedError(
        f"the card's background kernels do not run {n_levels} levels x {n_features} features, "
        f"bg_net hidden {hidden}, {layers} layers, SH degree {sh_degree} yet "
        f"({BG_GEOMETRY_TODO}; they take rows of F in {KERNEL_FEATURES} features at up to "
        f"{KERNEL_MAX_LEVELS} levels and bg_net IN -> {BG_HIDDEN} -> 3 with SH degree "
        f"{BG_SH_DEGREE}); on the CPU (--cpu, device='cpu') every geometry runs through the "
        f"plain versions")


def _bwd_smem(IN, tile):
    return 4 * (IN * BG_HIDDEN + BG_HIDDEN * 3 + (IN + BG_HIDDEN + 3) * (tile + 1))


@functools.lru_cache(maxsize=None)
def kernel_args(meta: BgMeta, F: int) -> KernelArgs:
    """The kernels' static arguments for one geometry, built once."""
    L = len(meta.resolutions)
    check_bg_geometry(L, F, BG_HIDDEN, BG_LAYERS, meta.sh_degree)
    if meta.compute_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"compute dtype {meta.compute_dtype}")
    IN = L * F + meta.sh_degree**2
    res = np.ascontiguousarray(np.asarray(meta.resolutions, np.float32))
    tile = next(t for t in BWD_TILES if _bwd_smem(IN, t) <= SMEM_MAX)
    return KernelArgs(res, res.ctypes.data_as(_cuda._FP), float(np.float32(meta.radius**2)),
                      L, F, IN, IN * BG_HIDDEN + BG_HIDDEN * 3,
                      int(meta.compute_dtype == torch.bfloat16), tile)


def pack_bg_net(bg_net, compute_dtype):
    """``bg_net``'s matrices as the kernels read them: W1 [IN, 64] then W2
    [64, 3], one flat fp32 buffer, each weight rounded to the compute dtype
    first (``mlp_apply``'s ``w.to(compute_dtype)``); no gradient."""
    return torch.cat([w.detach().to(compute_dtype).float().reshape(-1) for w in bg_net])


def check_bg_buffers(table_g, packed, meta: BgMeta):
    """Validate, once per render or step, what every call of the kernels
    reads besides the rays: the table in the compute dtype and the packed
    weights, on one card."""
    a = kernel_args(meta, table_g.shape[-1])
    _cuda.check(table_g, "bg_table_g", meta.compute_dtype, (a.L << meta.log2_hashmap_size, a.F))
    _cuda.check(packed, "bg_packed", torch.float32, (a.n_weights,), table_g.device)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def background_plain(rays_o, rays_d, table, bg_net, meta: BgMeta, table_g=None):
    """Plain version of the forward: the chain of torch ops (K8's plain
    encoding of the sphere point, SH, ``mlp_apply``, the sigmoid) ->
    rgb [N, 3], differentiable through autograd."""
    from ..models.mlp import mlp_apply

    if table_g is None:
        table_g = table.detach().to(meta.compute_dtype)
    h2 = bg_encode(rays_o, rays_d, meta.radius, table, meta.resolutions,
                   meta.log2_hashmap_size, table_g=table_g, plain=True)
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    h = mlp_apply(bg_net, torch.cat([h2, sh_encode(d, meta.sh_degree)], dim=-1),
                  compute_dtype=meta.compute_dtype)
    return torch.sigmoid(h)


def background_bwd_plain(rays_o, rays_d, table, bg_net, g_rgb, meta: BgMeta, table_g=None):
    """Plain version of the backward: the chain's autograd written out, with
    the roundings the kernel makes -> (the table's gradient [rows, F], dW1
    [IN, 64], dW2 [64, 3]), fp32."""
    cd = meta.compute_dtype
    if table_g is None:
        table_g = table.detach().to(cd)
    w1, w2 = (w.detach().to(cd) for w in bg_net)
    x01 = sphere_x01(rays_o, rays_d, meta.radius)
    h2 = hash_encode_2d_plain(x01, table.detach(), meta.resolutions, meta.log2_hashmap_size,
                              table_g=table_g)
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    x = torch.cat([h2, sh_encode(d, meta.sh_degree)], dim=-1).to(cd)
    h1 = torch.relu(x @ w1)
    s = torch.sigmoid((h1 @ w2).float())
    g_h = (g_rgb * (1 - s) * s).to(cd)
    g_w2 = (h1.t() @ g_h).float()
    g_h1 = torch.where(h1 > 0, g_h @ w2.t(), torch.zeros((), dtype=cd))
    g_w1 = (x.t() @ g_h1).float()
    LF = h2.shape[-1]
    g_x = (g_h1 @ w1.t()).float()[:, :LF].contiguous()
    g_table = hash_encode_2d_bwd_plain(x01, g_x, table.shape[0], meta.resolutions,
                                       meta.log2_hashmap_size, table_g.dtype)
    return g_table, g_w1, g_w2


def relu_margin(rays_o, rays_d, table, bg_net, meta: BgMeta, table_g=None):
    """Each ray's distance from bg_net's ReLU kink: the least |layer-1
    pre-activation| over the hidden units, as the plain chain computes it
    (fp32 sums of the compute-dtype operands) -> [N] fp32.  Where it is a
    few ulps of the encoding from 0, two sums of other orders may put the
    unit on either side: the mask, and with it that ray's share of the
    table's and W1's gradients (not W2's: the activation is ~0 either way),
    may come out either way, as phi may at its cut (``hashenc.sphere_cut``)."""
    cd = meta.compute_dtype
    if table_g is None:
        table_g = table.detach().to(cd)
    x01 = sphere_x01(rays_o, rays_d, meta.radius)
    h2 = hash_encode_2d_plain(x01, table.detach(), meta.resolutions, meta.log2_hashmap_size,
                              table_g=table_g)
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    x = torch.cat([h2, sh_encode(d, meta.sh_degree)], dim=-1).to(cd).float()
    return (x @ bg_net[0].detach().to(cd).float()).abs().amin(dim=-1)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_rays(rays_o, rays_d, device):
    """N, with the rays checked once: [N, 3] fp32, contiguous, on ``device``,
    a card."""
    N = rays_o.shape[0]
    if not (rays_o.is_cuda and rays_o.dtype == rays_d.dtype == torch.float32
            and rays_o.shape == (N, 3)
            and rays_d.shape == (N, 3) and rays_o.device == rays_d.device == device
            and rays_o.is_contiguous() and rays_d.is_contiguous()):
        _cuda.check(rays_o, "rays_o", torch.float32, (N, 3), device)
        _cuda.check(rays_d, "rays_d", torch.float32, (N, 3), device)
    return N


def bg_color_kernel(rays_o, rays_d, table_g, packed, meta: BgMeta):
    """``bg_color_fwd`` -> rgb [N, 3] fp32 (``table_g`` and ``packed`` as
    ``check_bg_buffers`` validated them); no gradient (``BackgroundFn``
    wraps it)."""
    N = _check_rays(rays_o, rays_d, table_g.device)
    a = kernel_args(meta, table_g.shape[-1])
    rgb = torch.empty((N, 3), dtype=torch.float32, device=rays_o.device)
    _cuda.BG_COLOR(rays_o.data_ptr(), rays_d.data_ptr(), a.r2, table_g.data_ptr(), a.bf16, a.F,
                   packed.data_ptr(), rgb.data_ptr(), N, a.L, a.res_ptr, meta.log2_hashmap_size)
    return rgb


def _bg_color_bwd_kernel(rays_o, rays_d, table_g, packed, g_rgb, n_rows, meta: BgMeta):
    """``bg_color_bwd`` then ``bg_finish``: g_rgb [N, 3] -> (the table's
    gradient [n_rows, F], dW1 [IN, 64], dW2 [64, 3]), fp32 (views of one
    buffer for the weights); every row of the table's gradient is written
    by the kernels, so it needs no memset."""
    N = _check_rays(rays_o, rays_d, table_g.device)
    _cuda.check(g_rgb, "g_rgb", torch.float32, (N, 3), table_g.device)
    a = kernel_args(meta, table_g.shape[-1])
    dev = rays_o.device
    if N == 0:
        g_table = torch.zeros((n_rows, a.F), dtype=torch.float32, device=dev)
        g_w = torch.zeros((a.n_weights,), dtype=torch.float32, device=dev)
    else:
        g_table = torch.empty((n_rows, a.F), dtype=torch.float32, device=dev)
        g_w = torch.empty((a.n_weights,), dtype=torch.float32, device=dev)
        blocks = min(math.ceil(N / a.tile), _cuda.sm_count(dev))
        scratch = torch.empty((N * (a.L * a.F + 2),), dtype=torch.float32, device=dev)
        partials = torch.empty((blocks, a.n_weights), dtype=torch.float32, device=dev)
        _cuda.BG_COLOR_BWD(rays_o.data_ptr(), rays_d.data_ptr(), a.r2, table_g.data_ptr(),
                           a.bf16, a.F, packed.data_ptr(), g_rgb.data_ptr(), scratch.data_ptr(),
                           partials.data_ptr(), g_w.data_ptr(), g_table.data_ptr(), N, a.L,
                           a.res_ptr, meta.log2_hashmap_size, blocks, a.tile)
    n1 = a.IN * BG_HIDDEN
    return g_table, g_w[:n1].view(a.IN, BG_HIDDEN), g_w[n1:].view(BG_HIDDEN, 3)


class BackgroundFn(torch.autograd.Function):
    """The background colour with its backward.  Inputs: rays_o, rays_d
    [N, 3]; the fp32 master table and both ``bg_net`` matrices (the
    gradients' targets); the table in the compute dtype and the packed
    weights (``pack_bg_net``; no gradient); the ``BgMeta``.  Without an
    input that needs a gradient it records no node, and the backward never
    runs."""

    @staticmethod
    def forward(ctx, rays_o, rays_d, table, w1, w2, table_g, packed, meta):
        ctx.save_for_backward(rays_o, rays_d, table_g, packed)
        ctx.meta, ctx.n_rows = meta, table.shape[0]
        return bg_color_kernel(rays_o, rays_d, table_g, packed, meta)

    @staticmethod
    def backward(ctx, g_rgb):
        need = ctx.needs_input_grad[2:5]
        if not any(need):
            return (None,) * 8
        rays_o, rays_d, table_g, packed = ctx.saved_tensors
        g = _bg_color_bwd_kernel(rays_o, rays_d, table_g, packed, g_rgb.contiguous(),
                                 ctx.n_rows, ctx.meta)
        return (None, None, *(gi if n else None for gi, n in zip(g, need)), None, None, None)
