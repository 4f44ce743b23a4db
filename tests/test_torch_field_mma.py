"""The tensor-core K4 kernels' weight layout and route, on the CPU.

``csrc/field_mma.cu`` reads the MLP weights packed by
``models/ngp.py:pack_mlp_mma`` (``mma_layout``): rows padded for
``ldmatrix``, IN padded to 16, the colour layer 0 as Wc0' (a zero row 16
facing o[0], Wc0's rows 16-30 below it) and the last colour layer padded to
8 outputs.  These tests rebuild each matrix from the packed buffer, show
that the shifted colour layer is exact, and hold the heads computed from
the packed matrices against JAX's ``_sigma_head`` / ``ngp_color`` in fp32
(rtol 1e-6 and atol 1e-6: the same arithmetic with zeros added in the
padded places; the sums run in another order, which moves values near zero
by a few 1e-7).  The kernels themselves run on the card
(``test_torch_kernels.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import ngp as j_ngp
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import _cuda
from nerf_signature_tpu_torch.ops.sh import sh_encode

WIDTHS = {"full": (32, 64, 16, 64), "narrow": (8, 16, 16, 16)}
NARROW = dict(n_levels=4, hidden_dim=16, hidden_dim_color=16, log2_hashmap_size=12)


def _cfg(widths, dtype=torch.float32):
    return t_ngp.NGPConfig(compute_dtype=dtype, **({} if widths == "full" else NARROW))


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


def _pack(widths, seed=0):
    p = _params(widths, seed)
    flat = t_ngp.field_params(p, _cfg(widths))["mlp_flat"]
    return p, _unpack(t_ngp.pack_mlp_mma(flat, WIDTHS[widths]), WIDTHS[widths])


def _padded(w, rows, ld):
    out = torch.zeros((rows, ld))
    out[:w.shape[0], :w.shape[1]] = w
    return out


@pytest.mark.parametrize("widths", ["full", "narrow"])
def test_packed_buffer_rebuilds_each_matrix(widths):
    p, mats = _pack(widths)
    ws0, ws1 = p["sigma_net"]
    wc0, wc1, wc2 = p["color_net"]
    wc0p = torch.cat([wc0[:16], torch.zeros((1, wc0.shape[1])), wc0[16:]])
    want = {"s0": ws0, "s1": ws1, "c0": wc0p, "c1": wc1, "c2": wc2}
    for name, rows, cols, ld in t_ngp.mma_layout(WIDTHS[widths]):
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


@pytest.mark.parametrize("widths", ["full", "narrow"])
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


def _packed_heads(mats, widths, feat, dirs):
    """The heads as the tensor-core kernels compute them, from the packed
    matrices (in fp32): sigma, geo, rgb."""
    m = {name: mats[name][:, :cols] for name, _, cols, _ in t_ngp.mma_layout(widths)}
    x = torch.nn.functional.pad(feat, (0, m["s0"].shape[0] - feat.shape[1]))
    o = torch.relu(x @ m["s0"]) @ m["s1"]
    c = torch.cat([sh_encode(dirs, 4), o], -1)
    rgb = torch.sigmoid(torch.relu(torch.relu(c @ m["c0"]) @ m["c1"]) @ m["c2"])[:, :3]
    return torch.exp(o[:, 0]), o[:, 1:], rgb


@pytest.mark.parametrize("widths", ["full", "narrow"])
def test_packed_heads_match_jax(widths):
    p, mats = _pack(widths, seed=3)
    rng = np.random.default_rng(4)
    feat = rng.uniform(-1, 1, size=(1024, WIDTHS[widths][0])).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jcfg = j_ngp.NGPConfig(compute_dtype=jnp.float32,
                           **({} if widths == "full" else NARROW))
    pj = {k: [jnp.asarray(w.numpy()) for w in p[k]] for k in ("sigma_net", "color_net")}
    sj, gj = j_ngp._sigma_head(pj, jcfg, jnp.asarray(feat))
    rj = j_ngp.ngp_color(pj, jcfg, jnp.asarray(d), gj)
    st, gt, rt = _packed_heads(mats, WIDTHS[widths], torch.from_numpy(feat), torch.from_numpy(d))
    for a, b in ((st, sj), (gt, gj), (rt, rj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_sources_list_every_cu_file():
    cu = {n for n in os.listdir(_cuda.CSRC) if n.endswith(".cu")}
    assert set(_cuda.SOURCES) == cu


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
