"""CLIP text-image guidance for GT-free poses, in PyTorch.

Counterpart of ``nerf_signature_tpu/utils/clip_loss.py``: the negative
cosine similarity between the CLIP embedding of a rendered image and that
of a text prompt, the loss of the ``--clip_text`` train step on
``--rand_pose`` bundles (ref ``nerf/clip_utils.py:11-64``).  The vision
tower (ViT) is plain functions on a params dict, in the JAX package's
operation order: the patch conv without bias, the class token, the position
embedding, the pre-LN, the layers (LN, attention with q scaled by
``hd ** -0.5`` before ``q @ k^T`` and a plain softmax, LN, MLP with
``quick_gelu`` or exact GELU), the post-LN on token 0, the projection and
the L2 norm.  The image is first resized as ``jax.image.resize(...,
"bilinear")`` does (``resize_bilinear``: a triangle kernel, widened when it
shrinks, its weights renormalised at the edges).

Weights resolve through ``transformers`` (``openai/clip-vit-base-patch32``
or a local model via ``--clip_model``), imported only inside ``CLIPLoss``;
without it or its weights the loss is unavailable and ``CLIPLoss.error``
says why.  Text features take no gradient and are embedded once.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


# --------------------------------------------------------------- ingestion
def clip_vision_params_from_torch(model, device="cpu"):
    """A ``transformers`` CLIP vision tower with its projection (CLIPModel
    or CLIPVisionModelWithProjection) -> (params, meta).  Linear weights
    are stored [in, out], as the JAX package stores them; the patch conv
    stays OIHW."""
    def arr(t):
        return t.detach().to(device=device, dtype=torch.float32).clone()

    def lin(layer):
        return arr(layer.weight).t().contiguous()

    vm = getattr(model, "vision_model", None) or model.clip.vision_model
    cfg = vm.config
    emb = vm.embeddings
    params = {
        "class_embedding": arr(emb.class_embedding),
        "patch_embedding": arr(emb.patch_embedding.weight),  # [D, 3, p, p]
        "position_embedding": arr(emb.position_embedding.weight),
        "pre_ln": {"scale": arr(vm.pre_layrnorm.weight), "bias": arr(vm.pre_layrnorm.bias)},
        "post_ln": {"scale": arr(vm.post_layernorm.weight),
                    "bias": arr(vm.post_layernorm.bias)},
        "proj": lin(model.visual_projection),  # [D, P]
        "layers": [],
    }
    for lyr in vm.encoder.layers:
        a = lyr.self_attn
        params["layers"].append({
            "ln1": {"scale": arr(lyr.layer_norm1.weight), "bias": arr(lyr.layer_norm1.bias)},
            "ln2": {"scale": arr(lyr.layer_norm2.weight), "bias": arr(lyr.layer_norm2.bias)},
            "q_w": lin(a.q_proj), "q_b": arr(a.q_proj.bias),
            "k_w": lin(a.k_proj), "k_b": arr(a.k_proj.bias),
            "v_w": lin(a.v_proj), "v_b": arr(a.v_proj.bias),
            "o_w": lin(a.out_proj), "o_b": arr(a.out_proj.bias),
            "fc1_w": lin(lyr.mlp.fc1), "fc1_b": arr(lyr.mlp.fc1.bias),
            "fc2_w": lin(lyr.mlp.fc2), "fc2_b": arr(lyr.mlp.fc2.bias),
        })
    meta = {
        "n_heads": cfg.num_attention_heads,
        "patch": cfg.patch_size,
        "image_size": cfg.image_size,
        "act": getattr(cfg, "hidden_act", "quick_gelu"),
    }
    return params, meta


def clip_vision_params_from_jax(tree, meta, device="cpu"):
    """The JAX package's (params, meta) (arrays; the patch conv HWIO) -> the
    port's (the patch conv OIHW; every other leaf as it is)."""
    def conv(k, v):
        v = np.asarray(v, np.float32)
        if k == "patch_embedding":
            v = np.transpose(v, (3, 2, 0, 1))
        return torch.as_tensor(np.ascontiguousarray(v), device=device)

    def walk(k, v):
        if isinstance(v, dict):
            return {kk: walk(kk, vv) for kk, vv in v.items()}
        if isinstance(v, (list, tuple)):
            return [walk(k, vv) for vv in v]
        return conv(k, v)

    return walk(None, tree), dict(meta)


# ------------------------------------------------------------------ resize
@functools.lru_cache(maxsize=16)
def _resize_weights(n_in, n_out):
    """[n_in, n_out] fp32 weights of ``jax.image.resize``'s linear kernel
    (``scale_and_translate``: half-pixel centres, the triangle widened by
    1 / scale when shrinking, each column renormalised to sum 1, columns
    whose sample lies outside the input zero), on the CPU."""
    f32 = torch.float32
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(images, height, width):
    """[B, H, W, C] -> [B, height, width, C] as ``jax.image.resize(images,
    (B, height, width, C), "bilinear")`` computes it (antialiased when it
    shrinks; an axis whose size does not change is left as it is).
    Differentiable in ``images``."""
    x = images
    if x.shape[1] != height:
        wh = _resize_weights(x.shape[1], height).to(x.device)
        x = torch.einsum("bhwc,ho->bowc", x, wh)
    if x.shape[2] != width:
        ww = _resize_weights(x.shape[2], width).to(x.device)
        x = torch.einsum("bhwc,wp->bhpc", x, ww)
    return x


# ----------------------------------------------------------------- forward
def _ln(p, x, eps=1e-5):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean((x - mu) ** 2, -1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _act(kind, x):
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="none")


def _attn(lp, x, n_heads):
    B, T, D = x.shape
    hd = D // n_heads

    def split(h):
        return h.reshape(B, T, n_heads, hd).transpose(1, 2)

    q = split(x @ lp["q_w"] + lp["q_b"]) * (hd ** -0.5)
    k = split(x @ lp["k_w"] + lp["k_b"])
    v = split(x @ lp["v_w"] + lp["v_b"])
    w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = (w @ v).transpose(1, 2).reshape(B, T, D)
    return o @ lp["o_w"] + lp["o_b"]


def clip_image_features(params, meta, images):
    """images: [B, S, S, 3] in [0, 1], already at ``meta['image_size']``.
    Returns the L2-normalised projected features [B, P]."""
    dev = images.device
    x = (images - torch.as_tensor(_CLIP_MEAN, device=dev)) / torch.as_tensor(_CLIP_STD,
                                                                             device=dev)
    p = meta["patch"]
    x = F.conv2d(x.permute(0, 3, 1, 2), params["patch_embedding"], stride=p)  # [B, D, s, s]
    B, D = x.shape[:2]
    x = x.permute(0, 2, 3, 1).reshape(B, -1, D)
    cls = params["class_embedding"].expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + params["position_embedding"]
    x = _ln(params["pre_ln"], x)
    for lp in params["layers"]:
        x = x + _attn(lp, _ln(lp["ln1"], x), meta["n_heads"])
        h = _ln(lp["ln2"], x)
        h = _act(meta["act"], h @ lp["fc1_w"] + lp["fc1_b"])
        x = x + (h @ lp["fc2_w"] + lp["fc2_b"])
    pooled = _ln(params["post_ln"], x[:, 0])
    feats = pooled @ params["proj"]
    return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)


def clip_guidance_loss(params, meta, text_features, images):
    """-mean cos(text, image) for rendered images [B, H, W, 3] in [0, 1],
    differentiable in ``images`` (ref ``clip_utils.py:49-64``)."""
    S = meta["image_size"]
    x = torch.clamp(resize_bilinear(images, S, S), 0.0, 1.0)
    feats = clip_image_features(params, meta, x)
    return -torch.mean(feats @ text_features.T)


# -------------------------------------------------------------- host shell
class CLIPLoss:
    """Loads the weights (or marks itself unavailable with the reason in
    ``error``), embeds the text prompt once, holds the vision params on
    ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, model_name="openai/clip-vit-base-patch32", device=None):
        self.available = False
        self.params = self.meta = self.text_features = None
        try:
            from transformers import CLIPModel, CLIPProcessor

            self._model = CLIPModel.from_pretrained(model_name)
            self._processor = CLIPProcessor.from_pretrained(model_name)
            self._model.eval()
        except Exception as e:  # no transformers, or no weights at model_name
            self.error = (
                f"CLIP weights unavailable ({model_name}): {e}. "
                "Provide a local model path via --clip_model.")
            return
        from .device import resolve_device

        self.device = resolve_device(device)
        self.params, self.meta = clip_vision_params_from_torch(self._model, self.device)
        self.available = True

    @torch.no_grad()
    def prepare_text(self, texts):
        if not self.available:
            return
        if isinstance(texts, str):
            texts = [texts]
        inputs = self._processor(text=texts, return_tensors="pt", padding=True)
        tf = self._model.get_text_features(**inputs)
        tf = tf / tf.norm(dim=-1, keepdim=True)
        self.text_features = tf.to(device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def __call__(self, images):
        """Scalar loss for [B, H, W, 3] images in [0, 1]."""
        if not self.available:
            raise RuntimeError(self.error)
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        return float(clip_guidance_loss(self.params, self.meta, self.text_features, x))
