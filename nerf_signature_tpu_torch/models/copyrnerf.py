"""CopyRNeRF baseline: the message enters through a colour-space MLP
(counterpart of ``nerf_signature_tpu/models/copyrnerf.py``).

Per sample, the MLP ``[pe(2 x01 - 1) 60, pe(d) 24, rgb 3, sigma_raw 1,
2 m - 1 (D)] -> 256 -> 256 -> 3`` (ReLU) gives the watermarked colour:
``clip(rgb + 0.5 tanh(out), 0, 1)``, a residual blend that starts at the
clean render at zero init, or with ``replace`` the upstream design's
``sigmoid(out)``.  Density is untouched.  Its input is K10
(``ops/copyrnerf.py``: one pass over the compacted samples on the card);
its three products are fp32 ``torch.matmul`` whatever the backbone's
compute dtype (JAX casts to fp32 and computes them outside any kernel),
with TF32 left as PyTorch sets it (off).  Params: ``{"layers": [{"w": [in,
out], "b": [out]}, ...]}``, JAX's tree.
"""

import math

import torch

from ..ops.copyrnerf import (  # noqa: F401  (freq_encode: the module's API, as in JAX)
    N_FIXED,
    copyrnerf_input,
    copyrnerf_input_from01,
    copyrnerf_input_plain,
    freq_encode,
)


def init_copyrnerf_mlp(generator, message_dim, width=256, depth=3, device="cpu"):
    """The message-colour MLP's params from a (CPU) ``torch.Generator``:
    each layer's weight and bias U(+-1/sqrt(in))."""
    dims = [N_FIXED + message_dim] + [width] * (depth - 1) + [3]
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = 1.0 / math.sqrt(a)
        w = (torch.rand((a, b), generator=generator) * 2.0 - 1.0) * bound
        bias = (torch.rand((b,), generator=generator) * 2.0 - 1.0) * bound
        layers.append({"w": w.to(device), "b": bias.to(device)})
    return {"layers": layers}


def mlp_leaves(params):
    """The MLP's tensors in the JAX tree's order (per layer b, then w)."""
    return [t for layer in params["layers"] for t in (layer["b"], layer["w"])]


def copyrnerf_head(params, h, rgb, replace=False):
    """The MLP on its input h [M, 88 + D], then the blend with rgb [M, 3]."""
    layers = params["layers"]
    for layer in layers[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    out = h @ layers[-1]["w"] + layers[-1]["b"]
    if replace:
        return torch.sigmoid(out)
    return torch.clamp(rgb + torch.tanh(out) * 0.5, 0.0, 1.0)


def copyrnerf_color(params, x01, d, rgb, sigma_raw, message, replace=False):
    """JAX's ``copyrnerf_color``: x01 [N, 3] in [0, 1], d [N, 3], rgb [N, 3],
    sigma_raw [N], message [D] 0/1 -> the watermarked colour [N, 3] (plain
    PyTorch)."""
    h = copyrnerf_input_from01(x01, d, rgb, sigma_raw, message)
    return copyrnerf_head(params, h, rgb.to(torch.float32), replace)


def copyrnerf_color_at(params, x, d, rgb, sigma_raw, message, bound, replace=False,
                       plain=False):
    """The watermarked colour of samples at x in [-bound, bound]: K10 for
    the input (its plain version on the CPU, or with ``plain``), then the
    MLP."""
    build = copyrnerf_input_plain if plain else copyrnerf_input
    h = build(x, d, rgb, sigma_raw, message, bound)
    return copyrnerf_head(params, h, rgb, replace)
