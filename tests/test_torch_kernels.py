"""The port's CUDA kernels (K1-K4, forward and backward) against their
plain PyTorch versions on the same inputs, on the card.  Skipped where no
GPU is visible.

This file imports torch and the port only, so it runs where JAX is not
installed, without the repo's JAX conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Limits: the marcher bit for bit, with and without perturbation noise (same
roundings, no FMA contraction); the hash encoder and compositor within an
fp32 ulp; the field heads at fp32 within 1e-5 relative, at bf16 within one
bf16 step (see test_torch_field).  Backward (relative L2 over the whole
gradient): the hash encoder's scatter-add and the compositor 1e-5 (atomic
and summation order), the field heads 1e-5 at fp32 and 1e-2 at bf16 (a
bf16 step where the kernel's fp32 sums and cuBLAS's round differently).
"""

import numpy as np
import pytest
import torch

from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import composite as t_comp
from nerf_signature_tpu_torch.ops import hashenc as t_hash
from nerf_signature_tpu_torch.ops import marching as t_march

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: these tests launch CUDA kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel test, run on the card")
    return torch.device("cuda")


def _rays(rng, n, bound):
    o = rng.normal(size=(n, 3)) * 0.3 * bound + np.array([0.0, 0.0, -2.6 * bound])
    d = rng.normal(size=(n, 3)) * 0.25 + np.array([0.0, 0.0, 1.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)


@pytest.mark.parametrize("gather", ["bf16", "fp32", "dense"])
def test_hash_encode_kernel_matches_plain(cuda, gather):
    g = torch.Generator().manual_seed(0)
    res = t_hash.level_resolutions(16, 16, 2048)
    sides = t_hash.level_sides(res, 19, True) if gather == "dense" else None
    rows = int(t_hash.level_row_counts(sides, 19).sum()) if sides else 16 << 19
    table = (torch.rand((rows, 2), generator=g) * 2 - 1).to(cuda)
    x = (torch.rand((1 << 16, 3), generator=g) * 1.1 - 0.05).to(cuda)
    gd = None if gather == "fp32" else torch.bfloat16
    k = t_hash.hash_encode(x, table, res, 19, gather_dtype=gd, dense_sides=sides)
    p = t_hash.hash_encode_plain(x, table, res, 19, gather_dtype=gd, dense_sides=sides)
    torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("use_mask", [True, False])
def test_composite_kernel_matches_plain(cuda, use_mask):
    g = torch.Generator().manual_seed(1)
    N, S = 4096, 256
    sig = torch.empty((N, S)).exponential_(1 / 3.0, generator=g)
    sig[: N // 4] *= 60.0
    rgb = torch.rand((N, S, 3), generator=g)
    dt = torch.rand((N, S), generator=g) * 0.045 + 0.005
    ts = torch.cumsum(dt, -1)
    mask = torch.rand((N, S), generator=g) < 0.8 if use_mask else None
    args = [v.to(cuda) for v in (sig, rgb, dt, ts)]
    m = None if mask is None else mask.to(cuda)
    k = t_comp.composite_rays(*args, mask=m)
    p = t_comp.composite_rays_plain(*args, mask=m)
    for name in k:
        torch.testing.assert_close(k[name], p[name], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bound,prefilter,gamma", [
    (b, pf, g) for b in (1.0, 2.0) for pf in (True, False) for g in (0.0, 1 / 128)])
def test_march_kernel_matches_plain(cuda, bound, prefilter, gamma):
    rng = np.random.default_rng(2)
    C = 1 if bound <= 1 else 2
    occ = torch.tensor(rng.uniform(size=(C, 128, 128, 128)) < 0.05).to(cuda)
    o, d = (v.to(cuda) for v in _rays(rng, 4096, bound))
    aabb = (-bound,) * 3 + (bound,) * 3
    kw = dict(min_near=0.2, bound=bound, dt_gamma=gamma, max_steps=1024, budget=256,
              prefilter=prefilter)
    k = t_march.march_rays_aabb(o, d, aabb, occ, **kw)
    p = t_march.march_rays_aabb(o, d, aabb, occ, plain=True, **kw)
    assert k["mask"].any()
    for name in p:
        assert torch.equal(k[name], p[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", ["full", "narrow"])
def test_field_kernel_matches_plain(cuda, dtype, widths):
    kw = {} if widths == "full" else dict(n_levels=4, hidden_dim=16, hidden_dim_color=16,
                                          log2_hashmap_size=12)
    cfg = t_ngp.NGPConfig(compute_dtype=dtype, **kw)
    params = t_ngp.init_ngp_params(torch.Generator().manual_seed(3), cfg, cuda)
    params["hash_table"].mul_(1e4)
    fp = t_ngp.field_params(params, cfg)
    g = torch.Generator().manual_seed(4)
    x = (torch.rand((1 << 16, 3), generator=g) * 2 - 1).to(cuda)
    d = torch.nn.functional.normalize(torch.randn((1 << 16, 3), generator=g), dim=-1).to(cuda)
    feat = t_ngp._encode_pos(fp, cfg, x)
    sk, gk, rk = t_ngp.field_heads(fp, cfg, feat, d, want_geo=True)
    sp, gp, rp = t_ngp.field_heads_plain(fp, cfg, feat, d)
    if dtype == torch.float32:
        for a, b in ((sk, sp), (gk, gp), (rk, rp)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(sk, sp, rtol=2e-2, atol=0)
        torch.testing.assert_close(rk, rp, rtol=0, atol=1e-2)
        torch.testing.assert_close(gk, gp, rtol=2e-2, atol=1e-2)


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("bound,prefilter,gamma", [(1.0, None, 0.0), (2.0, True, 1 / 128),
                                                   (2.0, False, 1 / 128)])
def test_march_kernel_with_noise_matches_plain(cuda, bound, prefilter, gamma):
    rng = np.random.default_rng(3)
    C = 1 if bound <= 1 else 2
    occ = torch.tensor(rng.uniform(size=(C, 128, 128, 128)) < 0.05).to(cuda)
    o, d = (v.to(cuda) for v in _rays(rng, 4096, bound))
    noise = torch.rand(4096, generator=torch.Generator().manual_seed(4)).to(cuda)
    aabb = (-bound,) * 3 + (bound,) * 3
    kw = dict(min_near=0.2, bound=bound, dt_gamma=gamma, max_steps=1024, budget=128,
              prefilter=prefilter, noise=noise)
    k = t_march.march_rays_aabb(o, d, aabb, occ, **kw)
    p = t_march.march_rays_aabb(o, d, aabb, occ, plain=True, **kw)
    still = t_march.march_rays_aabb(o, d, aabb, occ, **dict(kw, noise=None))
    assert k["mask"].any() and not torch.equal(k["ts"], still["ts"])
    for name in p:
        assert torch.equal(k[name], p[name]), name


@pytest.mark.parametrize("gather", ["bf16", "fp32", "dense"])
def test_hash_encode_bwd_kernel_matches_plain(cuda, gather):
    g = torch.Generator().manual_seed(5)
    res = t_hash.level_resolutions(16, 16, 2048)
    sides = t_hash.level_sides(res, 19, True) if gather == "dense" else None
    rows = int(t_hash.level_row_counts(sides, 19).sum()) if sides else 16 << 19
    x = (torch.rand((1 << 16, 3), generator=g) * 1.1 - 0.05).to(cuda)
    g_feat = torch.randn((1 << 16, 32), generator=g).to(cuda)
    g_feat[::3] = 0.0  # padded samples
    gd = torch.float32 if gather == "fp32" else torch.bfloat16
    k = t_hash._hash_encode_bwd_kernel(x, g_feat, rows, res, 19, gd, False, sides)
    p = t_hash.hash_encode_bwd_plain(x, g_feat, rows, res, 19, gd, dense_sides=sides)
    assert rel_l2(k, p) <= 1e-5
    # through autograd: the table's gradient is the kernel's
    table = torch.zeros((rows, 2), device=cuda, requires_grad=True)
    feat = t_hash.hash_encode(x, table, res, 19, gather_dtype=gd, dense_sides=sides)
    feat.backward(g_feat)
    assert rel_l2(table.grad, p) <= 1e-5


@pytest.mark.parametrize("use_mask", [True, False])
def test_composite_bwd_kernel_matches_plain(cuda, use_mask):
    g = torch.Generator().manual_seed(6)
    N, S = 4096, 128
    sig = torch.empty((N, S)).exponential_(1 / 3.0, generator=g)
    sig[: N // 4] *= 60.0
    rgb = torch.rand((N, S, 3), generator=g)
    dt = torch.rand((N, S), generator=g) * 0.045 + 0.005
    ts = torch.cumsum(dt, -1)
    mask = (torch.rand((N, S), generator=g) < 0.8).to(cuda) if use_mask else None
    cts = [torch.randn(shape, generator=g).to(cuda) for shape in ((N,), (N,), (N, 3), (N, S))]
    grads = []
    for fn in (t_comp.composite_rays, t_comp.composite_rays_plain):
        s_, r_ = sig.to(cuda).requires_grad_(True), rgb.to(cuda).requires_grad_(True)
        out = fn(s_, r_, dt.to(cuda), ts.to(cuda), mask=mask)
        torch.autograd.backward([out[k] for k in ("weights_sum", "depth", "image", "weights")],
                                cts)
        grads.append((s_.grad, r_.grad))
    (sk, rk), (sp, rp) = grads
    assert rel_l2(sk, sp) <= 1e-5 and rel_l2(rk, rp) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", ["full", "narrow"])
def test_field_bwd_kernel_matches_plain(cuda, dtype, widths):
    kw = {} if widths == "full" else dict(n_levels=4, hidden_dim=16, hidden_dim_color=16,
                                          log2_hashmap_size=12)
    cfg = t_ngp.NGPConfig(compute_dtype=dtype, **kw)
    params = t_ngp.init_ngp_params(torch.Generator().manual_seed(7), cfg, cuda)
    params["hash_table"].mul_(1e4)
    g = torch.Generator().manual_seed(8)
    M = 100_000  # not a multiple of the 128-sample tile
    x = (torch.rand((M, 3), generator=g) * 2 - 1).to(cuda)
    d = torch.nn.functional.normalize(torch.randn((M, 3), generator=g), dim=-1).to(cuda)
    with torch.no_grad():
        feat = t_ngp._encode_pos(t_ngp.field_params(params, cfg), cfg, x)
    g_sigma = torch.randn(M, generator=g).to(cuda) * 1e-3
    g_rgb = torch.randn((M, 3), generator=g).to(cuda) * 1e-3
    # padded samples carry zero cotangents; whole 128-sample tiles of them
    # are skipped by the kernel
    dead = (torch.arange(M, device=cuda) // 128) % 3 == 0
    g_sigma[dead] = 0.0
    g_rgb[dead] = 0.0
    grads = []
    for heads in (t_ngp.field_heads, lambda p, c, f, dd: t_ngp.field_heads_plain(p, c, f, dd)):
        nets = [w.clone().requires_grad_(True) for w in params["sigma_net"] + params["color_net"]]
        p = dict(params, sigma_net=nets[:2], color_net=nets[2:])
        f = feat.clone().requires_grad_(True)
        sigma, _, rgb = heads(t_ngp.field_params(p, cfg), cfg, f, d)
        torch.autograd.backward([sigma, rgb], [g_sigma, g_rgb])
        grads.append([f.grad] + [w.grad for w in nets])
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(*grads):
        assert rel_l2(a, b) <= lim
    # the weight gradient is deterministic (fixed-order block partials)
    fp = t_ngp.field_params(params, cfg)
    w = t_ngp._kernel_widths(params, cfg)
    once = t_ngp.field_heads_bwd(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb)
    again = t_ngp.field_heads_bwd(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb)
    assert torch.equal(once[1], again[1]) and torch.equal(once[0], again[0])


def test_wrappers_raise_instead_of_falling_back(cuda):
    occ = torch.zeros((1, 128, 128, 128), dtype=torch.bool, device=cuda)
    o = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        t_march.march_rays_aabb(o, torch.ones((3, 8), device=cuda).t(), (-1, -1, -1, 1, 1, 1),
                                occ, min_near=0.2, bound=1.0)
    with pytest.raises(NotImplementedError, match="bool occupancy"):
        t_march.march_rays_aabb(o, o + 1, (-1, -1, -1, 1, 1, 1), occ.float(),
                                min_near=0.2, bound=1.0)
