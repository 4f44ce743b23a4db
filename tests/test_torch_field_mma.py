"""The tensor-core K4 kernels' weight layout and route, on the CPU.

``csrc/field_mma*.cu`` read the MLP weights packed by
``models/ngp.py:pack_mlp_mma`` (``mma_layout``): rows padded for
``ldmatrix``, IN padded to 16, the colour layer 0 as Wc0' (a zero row 16
facing o[0], Wc0's rows 16-30 below it) and the last colour layer padded to
8 outputs.  These tests rebuild each matrix from the packed buffer, show
that the shifted colour layer is exact, and hold the heads computed from
the packed matrices against JAX's ``_sigma_head`` / ``ngp_color`` in fp32
(rtol 1e-6 and atol 1e-6: the same arithmetic with zeros added in the
padded places; the sums run in another order, which moves values near zero
by a few 1e-7).  The full backward sums the weight gradient in the packed
layout and reads it back through ``mma_grad_to_flat``: the map is the
adjoint of the pack, and autograd through the packed heads, then the map,
is JAX's VJP.  An encoding width K4 lacks (24 at 12 x 2, 48 at 12 x 4)
runs at the next built input width: ``field_params``' ``mlp_flat`` appends
zero rows to Ws0, the pack carries them, and the way back (the map, then
the cat's backward) drops their gradients.  The kernels themselves run on
the card (``test_torch_kernels.py``).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import _cuda
from nerf_signature_tpu_torch.ops.activation import trunc_exp
from nerf_signature_tpu_torch.ops.sh import sh_encode

# the params' widths: "full": 16 levels x 2 features (and 8 x 4, the same
# widths); "8x2": IN = 16; "16x4": IN = 64 (and 32 x 2); "w24" (12 x 2) and
# "w48" (12 x 4): encoding widths 24 and 48, run at the built 32 and 64
WIDTHS = {"full": (32, 64, 16, 64), "8x2": (16, 64, 16, 64), "16x4": (64, 64, 16, 64),
          "narrow": (8, 16, 16, 16), "w24": (24, 64, 16, 64), "w48": (48, 64, 16, 64)}
CFGS = {"full": {}, "8x2": dict(n_levels=8), "16x4": dict(n_features=4),
        "narrow": dict(n_levels=4, hidden_dim=16, hidden_dim_color=16, log2_hashmap_size=12),
        "w24": dict(n_levels=12), "w48": dict(n_levels=12, n_features=4)}


def _cfg(widths, dtype=torch.float32):
    return t_ngp.NGPConfig(compute_dtype=dtype, **CFGS[widths])


def _params(widths, seed=0):
    return t_ngp.init_ngp_params(torch.Generator().manual_seed(seed), _cfg(widths))


def _unpack(packed, widths):
    """The packed buffer's matrices, padding included, by ``mma_layout``."""
    mats, off = {}, 0
    for name, rows, _, ld in t_ngp.mma_layout(widths):
        mats[name] = packed[off:off + rows * ld].reshape(rows, ld)
        off += rows * ld
    assert off == packed.numel()
    return mats


def _built(widths):
    """K4's built widths for these params' widths: IN the next built width."""
    return t_ngp._built_widths(WIDTHS[widths])


def _pack(widths, seed=0):
    p = _params(widths, seed)
    flat = t_ngp.field_params(p, _cfg(widths))["mlp_flat"]
    return p, _unpack(t_ngp.pack_mlp_mma(flat, _built(widths)), _built(widths))


def _shapes(w):
    in_dim, hidden, out1, hc = w
    return [(in_dim, hidden), (hidden, out1), (16 + out1 - 1, hc), (hc, hc), (hc, 3)]


def _mlp_flat(x, widths):
    """The weights in ``x`` (mlp_flat at the params' widths) -> the card's
    ``mlp_flat`` at the built widths, by ``field_params`` itself."""
    ws = [v.reshape(shape) for v, shape in zip(
        torch.split(x, [a * b for a, b in _shapes(WIDTHS[widths])]), _shapes(WIDTHS[widths]))]
    p = {"hash_table": torch.zeros((1, 2)), "sigma_net": ws[:2], "color_net": ws[2:]}
    return t_ngp.field_params(p, _cfg(widths))["mlp_flat"]


def _params_grad(g_flat, widths):
    """A gradient of the card's ``mlp_flat`` -> the params' (``mlp_flat``
    at their widths): autograd through ``field_params``' cat, which drops
    the padded rows of Ws0."""
    x = torch.zeros(t_ngp._n_weights(WIDTHS[widths]), dtype=g_flat.dtype, requires_grad=True)
    (g,) = torch.autograd.grad(_mlp_flat(x, widths), x, g_flat)
    return g


def _padded(w, rows, ld):
    out = torch.zeros((rows, ld))
    out[:w.shape[0], :w.shape[1]] = w
    return out


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_packed_buffer_rebuilds_each_matrix(widths):
    p, mats = _pack(widths)
    ws0, ws1 = p["sigma_net"]
    wc0, wc1, wc2 = p["color_net"]
    wc0p = torch.cat([wc0[:16], torch.zeros((1, wc0.shape[1])), wc0[16:]])
    want = {"s0": ws0, "s1": ws1, "c0": wc0p, "c1": wc1, "c2": wc2}
    # Ws0's rows past the params' width (and past IN, up to 16) are zero
    for name, rows, cols, ld in t_ngp.mma_layout(_built(widths)):
        assert rows % 16 == 0 and cols % 8 == 0 and (ld * 2) % 16 == 0, name
        assert (ld * 2 // 16) % 2 == 1, f"{name}: an even row stride in 16-byte units"
        assert torch.equal(mats[name], _padded(want[name], rows, ld)), name
    assert torch.equal(mats["c0"][16], torch.zeros_like(mats["c0"][16]))


def _ordered_matmul(x, w):
    """x @ w with each output summed over k in order, one rounding a step."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype)
    for k in range(x.shape[1]):
        acc = acc + x[:, k:k + 1] * w[k]
    return acc


def _bf16(t):
    return t.to(torch.bfloat16).float()


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_shifted_colour_layer_is_exact(widths):
    """[SH, o] @ Wc0' == [SH, o[1:]] @ Wc0: exactly in fp32, on the
    bf16-rounded operands the kernel multiplies, and after the output's
    bf16 rounding."""
    p, mats = _pack(widths, seed=1)
    hc = WIDTHS[widths][3]
    wc0, wc0p = p["color_net"][0], mats["c0"][:, :hc]
    rng = np.random.default_rng(2)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    sh = sh_encode(torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True)), 4)
    o = torch.from_numpy(rng.normal(size=(512, 16)).astype(np.float32))
    ref = _ordered_matmul(torch.cat([sh, o[:, 1:]], -1), wc0)
    assert torch.equal(_ordered_matmul(torch.cat([sh, o], -1), wc0p), ref)
    ref_b = _ordered_matmul(_bf16(torch.cat([sh, o[:, 1:]], -1)), _bf16(wc0))
    got_b = _ordered_matmul(_bf16(torch.cat([sh, o], -1)), _bf16(wc0p))
    assert torch.equal(got_b, ref_b)
    assert torch.equal(_bf16(got_b), _bf16(ref_b))


def _packed_heads(mats, widths, feat, dirs, dtype=torch.float32):
    """The heads as the tensor-core kernels compute them, from the packed
    matrices, in ``dtype`` (each layer's output rounded where ``mlp_apply``
    rounds it): sigma, geo, rgb, fp32."""
    m = {name: mats[name][:, :cols].to(dtype) for name, _, cols, _ in t_ngp.mma_layout(widths)}
    x = torch.nn.functional.pad(feat, (0, m["s0"].shape[0] - feat.shape[1])).to(dtype)
    o = torch.relu(x @ m["s0"]) @ m["s1"]
    c = torch.cat([sh_encode(dirs, 4).to(dtype), o], -1)
    c3 = torch.relu(torch.relu(c @ m["c0"]) @ m["c1"]) @ m["c2"]
    o = o.float()
    return trunc_exp(o[:, 0]), o[:, 1:], torch.sigmoid(c3.float())[:, :3]


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_packed_heads_match_jax(widths):
    p, mats = _pack(widths, seed=3)
    rng = np.random.default_rng(4)
    feat = rng.uniform(-1, 1, size=(1024, WIDTHS[widths][0])).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jcfg = j_ngp.NGPConfig(compute_dtype=jnp.float32, **CFGS[widths])
    pj = {k: [jnp.asarray(w.numpy()) for w in p[k]] for k in ("sigma_net", "color_net")}
    sj, gj = j_ngp._sigma_head(pj, jcfg, jnp.asarray(feat))
    rj = j_ngp.ngp_color(pj, jcfg, jnp.asarray(d), gj)
    st, gt, rt = _packed_heads(mats, _built(widths), torch.from_numpy(feat), torch.from_numpy(d))
    for a, b in ((st, sj), (gt, gj), (rt, rj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_sources_list_every_cu_file():
    cu = {n for n in os.listdir(_cuda.CSRC) if n.endswith(".cu")}
    assert set(_cuda.SOURCES) == cu


def test_field_widths_are_the_ones_the_sources_instantiate():
    """FIELD_WIDTHS (the split build, the geometry check) and the C list
    NGP_FIELD_WIDTHS (every K4 source's dispatch) are the same widths; the
    SIMT sources are compiled once a width and once for the entry points."""
    with open(os.path.join(_cuda.CSRC, "field_common.cuh")) as f:
        line = next(ln for ln in f if ln.startswith("#define NGP_FIELD_WIDTHS(X)"))
    widths = tuple(tuple(int(v) for v in m.split(","))
                   for m in re.findall(r"X\(([\d, ]+)\)", line))
    assert widths == _cuda.FIELD_WIDTHS
    jobs = [(src, flags) for _, src, flags in _cuda._jobs()]
    for name in _cuda.SPLIT_BY_WIDTH:
        mine = [flags for src, flags in jobs if src == name]
        assert len(mine) == 1 + len(widths)
        split = sorted(sum("-DNGP_IN=" in f for f in fl) for fl in mine)
        assert split == [0] + [1] * len(widths)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_follows_the_dtype(monkeypatch, dtype):
    """bf16 launches the tensor-core kernels, fp32 the SIMT ones, each
    counted under its own name; the wrappers are driven here with the C
    entry points replaced by recorders."""
    k = _cuda.KERNELS
    assert (k["K4_field"], k["K4_field_bwd_feat"]) == (_cuda.FIELD_MMA, _cuda.FIELD_BWD_FEAT_MMA)
    assert (k["K4_field_f32"], k["K4_field_bwd_feat_f32"]) == (_cuda.FIELD, _cuda.FIELD_BWD_FEAT)
    calls = []
    for name in ("FIELD", "FIELD_MMA", "FIELD_BWD_FEAT", "FIELD_BWD_FEAT_MMA"):
        monkeypatch.setattr(_cuda, name, lambda *a, _n=name: calls.append((_n, a)))
    monkeypatch.setattr(_cuda, "check", lambda *a, **kw: None)
    cfg = _cfg("narrow", dtype)
    fp = t_ngp.field_params(_params("narrow"), cfg)
    widths = t_ngp._kernel_widths(fp, cfg)
    M = 64
    feat, dirs = torch.zeros((M, 8)), torch.zeros((M, 3))
    t_ngp._field_heads_kernel(cfg, fp["mlp_flat"], feat, dirs, True, widths)
    t_ngp.field_heads_bwd_feat(cfg, widths, feat, dirs, fp["mlp_flat"], torch.zeros(M),
                               torch.zeros((M, 3)))
    names = [n for n, _ in calls]
    if dtype == torch.bfloat16:
        assert names == ["FIELD_MMA", "FIELD_BWD_FEAT_MMA"]
        n_pack = sum(r * ld for _, r, _, ld in t_ngp.mma_layout(widths))
        assert n_pack == 2048 and len(calls[0][1]) == 11
    else:
        assert names == ["FIELD", "FIELD_BWD_FEAT"]
        assert calls[0][1][2] == fp["mlp_flat"].data_ptr()  # fp32 weights, unpacked
        assert calls[1][1][-1] == 0  # no rounding


def _n_pack(widths):
    return sum(rows * ld for _, rows, _, ld in t_ngp.mma_layout(widths))


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_packed_grad_map_is_the_adjoint_of_the_pack(widths):
    """<pack(x), y> == <x, map(y)>, and the map drops Wc0' row 16 and every
    padded place: a packed gradient there reaches no weight.  pack is
    ``field_params``' mlp_flat (Ws0 with zero rows up to the built input
    width) then ``pack_mlp_mma``; map is ``mma_grad_to_flat`` then the
    cat's backward."""
    w, b = WIDTHS[widths], _built(widths)
    n_w, n_pack = t_ngp._n_weights(w), _n_pack(b)
    assert n_w == sum(v.numel() for v in _params(widths)["sigma_net"] + _params(widths)["color_net"])
    assert _mlp_flat(torch.zeros(n_w), widths).numel() == t_ngp._n_weights(b)
    pack = lambda x: t_ngp.pack_mlp_mma(_mlp_flat(x, widths), b)
    grad_map = lambda y: _params_grad(t_ngp.mma_grad_to_flat(y, b), widths)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=n_w))
    y = torch.from_numpy(rng.normal(size=n_pack))
    lhs = float((pack(x) * y).sum())
    rhs = float((x * grad_map(y)).sum())
    assert lhs == pytest.approx(rhs, rel=1e-12)
    extras = pack(torch.ones(n_w, dtype=torch.float64)) == 0
    assert bool(_unpack(extras, b)["c0"][16].all())
    assert bool(_unpack(extras, b)["s0"][w[0]:].all())
    assert int(extras.sum()) == n_pack - n_w
    assert not bool(grad_map(torch.where(extras, y, 0.0)).any())
    assert bool(grad_map(torch.where(extras, 0.0, y)).ne(0).all())


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# bf16: both sides round at the same points (each activation and cotangent,
# each weight gradient once).  At these shapes they agree exactly (every
# leaf reads 0); the bound leaves room for sums taken in another order, where
# a value one bf16 step (0.4-0.8%) away carries through the layers below it,
# and is the card's limit for the kernel against autograd (chip_smoke.py).
BF16_REL_L2 = 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_full_bwd_emulation_matches_jax_vjp(widths, dtype):
    """The full backward's math on the CPU: autograd through the packed
    heads gives the packed weight gradient (Wc0' row 16 included), which
    the map reads back in mlp_flat order; with g_feat it is JAX's VJP of
    ``_sigma_head`` + ``ngp_color`` on the same seeded cotangents (fp32:
    elementwise rtol 1e-5; bf16: BF16_REL_L2 a leaf)."""
    w, bw = WIDTHS[widths], _built(widths)
    p = _params(widths, seed=6)
    flat = t_ngp.field_params(p, _cfg(widths))["mlp_flat"]
    rng = np.random.default_rng(7)
    M = 512
    feat = rng.uniform(-1, 1, size=(M, w[0])).astype(np.float32)
    d = rng.normal(size=(M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g_sigma = rng.normal(size=M).astype(np.float32)
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)
    g_sigma[::4] = 0.0  # padded samples
    g_rgb[::4] = 0.0

    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jcfg = j_ngp.NGPConfig(compute_dtype=jd, **CFGS[widths])

    def heads(ws, wc, f):
        pj = {"sigma_net": ws, "color_net": wc}
        sigma, geo = j_ngp._sigma_head(pj, jcfg, f)
        return sigma, j_ngp.ngp_color(pj, jcfg, jnp.asarray(d), geo)

    _, vjp = jax.vjp(heads, [jnp.asarray(v.numpy()) for v in p["sigma_net"]],
                     [jnp.asarray(v.numpy()) for v in p["color_net"]], jnp.asarray(feat))
    gws, gwc, gf_j = vjp((jnp.asarray(g_sigma), jnp.asarray(g_rgb)))
    leaves_j = [np.asarray(g, np.float32) for g in gws + gwc]

    packed = t_ngp.pack_mlp_mma(flat, bw).requires_grad_(True)
    f_t = torch.from_numpy(feat).requires_grad_(True)
    s_t, _, r_t = _packed_heads(_unpack(packed, bw), bw, f_t, torch.from_numpy(d), dtype)
    g_packed, gf_t = torch.autograd.grad([s_t, r_t], [packed, f_t],
                                         [torch.from_numpy(g_sigma), torch.from_numpy(g_rgb)])
    assert bool(_unpack(g_packed, bw)["c0"][16].ne(0).any())  # o[0]'s row: a gradient, dropped
    g_flat = t_ngp.mma_grad_to_flat(g_packed, bw)
    # Ws0's padded rows face zero features: their gradient is 0 before it is dropped
    assert not bool(g_flat[:bw[0] * bw[1]].reshape(bw[0], bw[1])[w[0]:].any())
    leaves_t = torch.split(_params_grad(g_flat, widths), [v.size for v in leaves_j])
    pairs = [(gf_t, np.asarray(gf_j, np.float32))] + [
        (a.reshape(b.shape), b) for a, b in zip(leaves_t, leaves_j)]
    for a, b in pairs:
        a = a.detach().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()))
        else:
            assert _rel_l2(a, b) <= BF16_REL_L2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_full_bwd_route_follows_the_dtype(monkeypatch, dtype):
    """Through FieldHeadsFn: bf16 launches the tensor-core full backward on
    the packed weights the forward saved, fp32 the SIMT one on the flat
    weights, each counted under its own name; the C entry points are
    replaced by recorders."""
    k = _cuda.KERNELS
    assert (k["K4_field_bwd"], k["K4_field_bwd_f32"]) == (_cuda.FIELD_BWD_MMA, _cuda.FIELD_BWD)
    calls = []
    for name in ("FIELD", "FIELD_MMA", "FIELD_BWD", "FIELD_BWD_MMA"):
        monkeypatch.setattr(_cuda, name, lambda *a, _n=name: calls.append((_n, a)))
    monkeypatch.setattr(_cuda, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: 132)
    cfg = _cfg("narrow", dtype)
    fp = t_ngp.field_params(_params("narrow"), cfg)
    widths = t_ngp._kernel_widths(fp, cfg)
    M = 1000
    flat = fp["mlp_flat"].clone().requires_grad_(True)
    feat = torch.zeros((M, 8), requires_grad=True)
    mma = t_ngp.pack_mlp_mma(flat.detach(), widths).to(torch.bfloat16)
    sigma, rgb = t_ngp.FieldHeadsFn.apply(feat, torch.zeros((M, 3)), flat, mma, cfg, widths)
    torch.autograd.backward([sigma, rgb], [torch.zeros(M), torch.zeros((M, 3))])
    assert flat.grad.shape == flat.shape and feat.grad.shape == feat.shape
    names = [n for n, _ in calls]
    args = calls[1][1]
    if dtype == torch.bfloat16:
        assert names == ["FIELD_MMA", "FIELD_BWD_MMA"]
        assert args[2] == mma.data_ptr() and len(args) == 15
        assert args[7] == t_ngp._mma_grad_index(widths, feat.device).data_ptr()
        assert args[9:11] == (M, 2)  # M, one block per 512-sample chunk (two here)
    else:
        assert names == ["FIELD", "FIELD_BWD"]
        assert args[2] == flat.data_ptr() and len(args) == 14
        assert args[8:10] == (M, 8)  # M, one block per 128-sample tile
