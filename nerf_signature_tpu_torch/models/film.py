"""FiLM/SIREN message encoder, the paper's ablated alternative to the
codebook encoder (counterpart of ``nerf_signature_tpu/models/film.py``).

A mapping MLP turns the bit string into per-layer (frequency, phase)
pairs that modulate sine layers over voxel features:
``x <- sin((15 freq + 30) (x W + b) + phase)``, then a linear layer.  No
entry point of either package calls it.  Params are JAX's tree: ``layers``
[{w [in, hidden], b}], ``final`` {w, b}, ``mapping`` {w1, b1, w2, b2}.
"""

import math

import torch
import torch.nn.functional as F


def _uniform(generator, shape, bound):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def init_film_msg_encoder(generator, message_dim=16, hidden=64, out_dim=2, n_layers=3,
                          feature_dim=2, device="cpu"):
    """Params from a (CPU) ``torch.Generator``: the first sine layer
    U(+-1/in), the later ones and the final layer U(+-sqrt(6/in)/25), the
    mapping net N(0, 0.1) and N(0, 0.01), biases zero (JAX's init)."""
    layers = []
    d_in = feature_dim
    for i in range(n_layers):
        bound = 1.0 / d_in if i == 0 else math.sqrt(6.0 / d_in) / 25.0
        layers.append({"w": _uniform(generator, (d_in, hidden), bound).to(device),
                       "b": torch.zeros((hidden,), device=device)})
        d_in = hidden
    final = {"w": _uniform(generator, (hidden, out_dim), math.sqrt(6.0 / hidden) / 25.0
                           ).to(device),
             "b": torch.zeros((out_dim,), device=device)}
    m_hidden = 64
    mapping = {
        "w1": (torch.randn((message_dim, m_hidden), generator=generator) * 0.1).to(device),
        "b1": torch.zeros((m_hidden,), device=device),
        "w2": (torch.randn((m_hidden, n_layers * 2 * hidden), generator=generator) * 0.01
               ).to(device),
        "b2": torch.zeros((n_layers * 2 * hidden,), device=device),
    }
    return {"layers": layers, "final": final, "mapping": mapping}


def film_msg_encode(params, features, message):
    """features [N, F] voxel features, message [D] bits -> [N, out_dim]."""
    n_layers = len(params["layers"])
    hidden = params["layers"][0]["w"].shape[1]
    mp = params["mapping"]
    msg = message.to(torch.float32) * 2.0 - 1.0
    h = F.leaky_relu(msg @ mp["w1"] + mp["b1"], 0.2)
    fp = (h @ mp["w2"] + mp["b2"]).reshape(n_layers, 2, hidden)
    freqs, phases = fp[:, 0], fp[:, 1]
    x = features
    for i, layer in enumerate(params["layers"]):
        z = x @ layer["w"] + layer["b"]
        x = torch.sin((freqs[i] * 15.0 + 30.0) * z + phases[i])
    return x @ params["final"]["w"] + params["final"]["b"]
