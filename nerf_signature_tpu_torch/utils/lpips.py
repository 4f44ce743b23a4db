"""LPIPS (alex) in PyTorch: the perceptual distance of the patch loss and
the ``LPIPSMeter``.

Counterpart of ``nerf_signature_tpu/utils/lpips.py``: plain functions on a
params dict ``{"convs": [{"w": [O, I, k, k], "b": [O]}] * 5, "lins": [C] *
5}``, in the JAX package's operation order: ``(x - shift) / scale``, the
five AlexNet convs (a 3x3/2 max-pool, VALID, before convs 1 and 2) with
their ReLU taps, ``f * rsqrt(sum(f^2) + 1e-10)`` over channels (not the
``lpips`` package's ``f / (sqrt(sum) + eps)``), the squared difference, the
lin weights, the spatial mean of each tap and the sum over taps.  It runs in
fp32 whatever the train dtype is.  The convs are ``F.conv2d`` (cuDNN on the
card); JAX computes them with ``lax.conv`` outside any Pallas kernel.

Weights come from a ``lpips.LPIPS(net='alex')`` state dict (``torch.save``
file, ``--lpips_weights`` or ``$LPIPS_WEIGHTS``) or the ``lpips`` package;
none ship with the repo.  An explicit path that does not exist raises.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

# lpips.ScalingLayer constants (lpips/lpips.py): input in [-1, 1]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision alexnet.features conv layout: (out_ch, in_ch, k, stride, pad)
_ALEX_CONVS = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
_POOL_BEFORE = {1, 2}  # a max-pool precedes convs 1 and 2
_CONV_IDX = [0, 3, 6, 8, 10]  # their indices in lpips' alexnet slices

MIN_SIZE = 32  # smallest H/W that survives the conv/pool stack


def init_lpips_params(generator, device="cpu"):
    """Random params with lpips-alex's shapes, from a ``torch.Generator``
    (CPU), placed on ``device``."""
    convs, lins = [], []
    for o, c, k, _, _ in _ALEX_CONVS:
        w = torch.randn((o, c, k, k), generator=generator) / np.sqrt(c * k * k)
        convs.append({"w": w.to(device), "b": torch.zeros((o,), device=device)})
    for o, _, _, _, _ in _ALEX_CONVS:
        lins.append((torch.randn((o,), generator=generator).abs() / o).to(device))
    return {"convs": convs, "lins": lins}


def lpips_params_from_state_dict(sd, device="cpu"):
    """A ``lpips.LPIPS(net='alex')`` state dict (tensors or arrays) -> params.
    Conv weights at ``net.slice{1..5}.{0,3,6,8,10}.weight/bias`` (OIHW, kept
    OIHW), lin heads at ``lin{0..4}.model.1.weight`` ([1, C, 1, 1])."""
    def arr(v):
        return torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v),
                               dtype=torch.float32, device=device)

    convs, lins = [], []
    for i, ci in enumerate(_CONV_IDX):
        convs.append({"w": arr(sd[f"net.slice{i + 1}.{ci}.weight"]),
                      "b": arr(sd[f"net.slice{i + 1}.{ci}.bias"])})
        lins.append(arr(sd[f"lin{i}.model.1.weight"]).reshape(-1))
    return {"convs": convs, "lins": lins}


def lpips_params_from_jax(tree, device="cpu"):
    """The JAX package's params pytree (arrays, conv weights HWIO) -> the
    port's (OIHW)."""
    def arr(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return {"convs": [{"w": arr(np.transpose(np.asarray(c["w"]), (3, 2, 0, 1))),
                       "b": arr(c["b"])} for c in tree["convs"]],
            "lins": [arr(v) for v in tree["lins"]]}


def load_lpips_params(path=None, device="cpu"):
    """The weights from an explicit state-dict file, ``$LPIPS_WEIGHTS``, or
    the ``lpips`` package (which needs its bundled checkpoints and
    torchvision's pretrained AlexNet).  Returns the params on ``device``, or
    None when none resolve; a named file that does not exist raises."""
    path = path or os.environ.get("LPIPS_WEIGHTS")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"--lpips_weights / $LPIPS_WEIGHTS points at {path!r}, "
                f"which does not exist")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        return lpips_params_from_state_dict(sd, device)
    try:
        import lpips as lpips_pkg

        model = lpips_pkg.LPIPS(net="alex")
        return lpips_params_from_state_dict(model.state_dict(), device)
    except Exception:  # the package or its pretrained weights are absent
        return None


def _alex_feats(params, x):
    """x: [B, 3, H, W] in [-1, 1] -> the 5 tap activations (NCHW)."""
    dev = x.device
    x = ((x - torch.as_tensor(_SHIFT, device=dev).view(1, 3, 1, 1))
         / torch.as_tensor(_SCALE, device=dev).view(1, 3, 1, 1))
    feats = []
    for i, ((_, _, _, s, p), conv) in enumerate(zip(_ALEX_CONVS, params["convs"])):
        if i in _POOL_BEFORE:
            x = F.max_pool2d(x, 3, stride=2)
        x = F.relu(F.conv2d(x, conv["w"], stride=s, padding=p) + conv["b"].view(1, -1, 1, 1))
        feats.append(x)
    return feats


def lpips_distance(params, img0, img1):
    """LPIPS(img0, img1) per batch element, differentiable.

    img0, img1: [B, H, W, 3] tensors in [0, 1] (taken to [-1, 1] as the
    ``lpips`` package expects), H, W >= MIN_SIZE.  Returns [B] fp32."""
    if img0.shape[1] < MIN_SIZE or img0.shape[2] < MIN_SIZE:
        raise ValueError(
            f"LPIPS needs images >= {MIN_SIZE}px (got {tuple(img0.shape[1:3])}); "
            "the AlexNet stack collapses below that")
    x0 = (img0.float() * 2.0 - 1.0).permute(0, 3, 1, 2)
    x1 = (img1.float() * 2.0 - 1.0).permute(0, 3, 1, 2)
    total = 0.0
    for f0, f1, lin in zip(_alex_feats(params, x0), _alex_feats(params, x1), params["lins"]):
        n0 = f0 * torch.rsqrt(torch.sum(f0 * f0, 1, keepdim=True) + 1e-10)
        n1 = f1 * torch.rsqrt(torch.sum(f1 * f1, 1, keepdim=True) + 1e-10)
        d = (n0 - n1) ** 2
        total = total + torch.mean(torch.sum(d * lin.view(1, -1, 1, 1), 1), dim=(1, 2))
    return total


@torch.no_grad()
def lpips_metric(params, img0, img1):
    """Mean LPIPS over a batch of [B, H, W, 3] arrays (float), computed on
    the params' device."""
    dev = params["lins"][0].device
    a = torch.as_tensor(np.asarray(img0, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(img1, np.float32), device=dev)
    return float(torch.mean(lpips_distance(params, a, b)))
