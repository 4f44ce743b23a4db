"""The port's CUDA kernels (K1-K4) against their plain PyTorch versions on
the same inputs, on the card.  Skipped where no GPU is visible.

This file imports torch and the port only, so it runs where JAX is not
installed, without the repo's JAX conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Limits: the marcher bit for bit (same roundings, no FMA contraction); the
hash encoder and compositor within an fp32 ulp; the field heads at fp32
within 1e-5 relative, at bf16 within one bf16 step (see test_torch_field).
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


def test_wrappers_raise_instead_of_falling_back(cuda):
    occ = torch.zeros((1, 128, 128, 128), dtype=torch.bool, device=cuda)
    o = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        t_march.march_rays_aabb(o, torch.ones((3, 8), device=cuda).t(), (-1, -1, -1, 1, 1, 1),
                                occ, min_near=0.2, bound=1.0)
    with pytest.raises(NotImplementedError, match="bool occupancy"):
        t_march.march_rays_aabb(o, o + 1, (-1, -1, -1, 1, 1, 1), occ.float(),
                                min_near=0.2, bound=1.0)
