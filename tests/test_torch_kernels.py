"""The port's CUDA kernels (K1-K4 forward and backward, K9 forward and
backward, the feature-only K4 backward, P1) against their plain PyTorch
versions on the same inputs, on the card.  Skipped where no GPU is
visible.

This file imports torch and the port only, so it runs where JAX is not
installed, without the repo's JAX conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Limits: the marcher bit for bit, with and without perturbation noise (same
roundings, no FMA contraction); the hash encoder and compositor within an
fp32 ulp; the field heads at fp32 (the SIMT kernel) within 1e-5 relative,
at bf16 (the tensor-core kernel) within one bf16 step (see
test_torch_field).  Backward (relative L2 over the whole gradient): the
hash encoder's scatter-add and the compositor 1e-5 (atomic and summation
order), the field heads 1e-5 at fp32 and 1e-2 at bf16 (a bf16 step where
the kernel's fp32 sums and cuBLAS's round differently).  K9 forward bit for
bit (the same adds in bit order, the same bf16 rounding) and its backward
exactly (a copy); the feature-only K4 backward equals the full one's g_feat
bit for bit (fp32: the same SIMT products; bf16: the same tensor-core
chain); the full K4 backward's weight gradient is deterministic (bit-equal
repeats); P1 equals ``table[idx]`` for any N and unaligned views.  K1 is
also held at rows of 1 and 8 features, at a padded output pitch (the
columns past L*F exactly 0; the backward reads the same pitch) and on its
backward's edges (M = 0, all-zero cotangents, one level of 2^19 rows, the
shared table); K4 at encoding widths 24 and 48 (run at 32 and 64); K9's
backward at any T * F and more than 32 bits.  K3 is
also held at its warp walk's edges (S not a multiple of the 32-slot chunk,
stops inside the first chunk and at its boundary, the mask absent or all
off, T_thresh 0, N = 0), its backward repeats bit-equal (no atomics).
"""

import numpy as np
import pytest
import torch

from nerf_signature_tpu_torch.kernel_cases import k3_edge_inputs
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import composite as t_comp
from nerf_signature_tpu_torch.ops import hashenc as t_hash
from nerf_signature_tpu_torch.ops import marching as t_march

pytestmark = pytest.mark.cuda

# K4's widths: "full" is 16 levels x 2 features (8 x 4 has the same widths),
# "8x2" encoding width 16, "16x4" width 64 (32 x 2 has the same), "narrow"
# the 8-wide test model; "12x2" (width 24) and "12x4" (width 48) run at the
# built 32 and 64, their features zero-padded by K1
WIDTHS = {"full": {}, "8x2": dict(n_levels=8), "16x4": dict(n_features=4),
          "narrow": dict(n_levels=4, hidden_dim=16, hidden_dim_color=16, log2_hashmap_size=12),
          "12x2": dict(n_levels=12), "12x4": dict(n_levels=12, n_features=4)}


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


@pytest.mark.parametrize("query", ["colour", "density"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_field_kernel_matches_plain(cuda, dtype, widths, query):
    from nerf_signature_tpu_torch.ops import _cuda

    kw = WIDTHS[widths]
    cfg = t_ngp.NGPConfig(compute_dtype=dtype, **kw)
    params = t_ngp.init_ngp_params(torch.Generator().manual_seed(3), cfg, cuda)
    params["hash_table"].mul_(1e4)
    fp = t_ngp.field_params(params, cfg)
    g = torch.Generator().manual_seed(4)
    M = (1 << 16) - 17  # not a multiple of the 32-sample warp tile
    x = (torch.rand((M, 3), generator=g) * 2 - 1).to(cuda)
    d = torch.nn.functional.normalize(torch.randn((M, 3), generator=g), dim=-1).to(cuda)
    d = d if query == "colour" else None  # density only: grid updates, meshing
    feat = t_ngp._encode_pos(fp, cfg, x)
    # K4's built input width; the columns past the encoding width are zeros
    assert feat.shape[1] == t_ngp._kernel_widths(params, cfg)[0]
    assert not bool(feat[:, cfg.enc_dim:].any())
    _cuda.reset_launch_counts()
    sk, gk, rk = t_ngp.field_heads(fp, cfg, feat, d, want_geo=True)
    route = "K4_field" if dtype == torch.bfloat16 else "K4_field_f32"
    counts = _cuda.launch_counts()
    assert counts[route] == 1 and counts["K4_field"] + counts["K4_field_f32"] == 1
    sp, gp, rp = t_ngp.field_heads_plain(fp, cfg, feat[:, :cfg.enc_dim], d)
    assert (rk is None) == (d is None)
    pairs = ((sk, sp), (gk, gp)) + (((rk, rp),) if d is not None else ())
    if dtype == torch.float32:
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(sk, sp, rtol=2e-2, atol=0)
        torch.testing.assert_close(gk, gp, rtol=2e-2, atol=1e-2)
        if d is not None:
            torch.testing.assert_close(rk, rp, rtol=0, atol=1e-2)


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
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_field_bwd_kernel_matches_plain(cuda, dtype, widths):
    """bf16: the tensor-core kernel (field_mma_bwd_full.cu); fp32: the SIMT
    one (field.cu)."""
    from nerf_signature_tpu_torch.ops import _cuda

    kw = WIDTHS[widths]
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
    # the plain version reads the encoding width; its g_feat is 0 past it,
    # as the kernel's is (Ws0's padded rows are zero)
    for heads in (t_ngp.field_heads,
                  lambda p, c, f, dd: t_ngp.field_heads_plain(p, c, f[:, :c.enc_dim], dd)):
        nets = [w.clone().requires_grad_(True) for w in params["sigma_net"] + params["color_net"]]
        p = dict(params, sigma_net=nets[:2], color_net=nets[2:])
        f = feat.clone().requires_grad_(True)
        _cuda.reset_launch_counts()
        sigma, _, rgb = heads(t_ngp.field_params(p, cfg), cfg, f, d)
        torch.autograd.backward([sigma, rgb], [g_sigma, g_rgb])
        grads.append([f.grad] + [w.grad for w in nets])
        if len(grads) == 1:
            counts = _cuda.launch_counts()
            route = "K4_field_bwd" if dtype == torch.bfloat16 else "K4_field_bwd_f32"
            assert counts[route] == 1
            assert counts["K4_field_bwd"] + counts["K4_field_bwd_f32"] == 1
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(*grads):
        assert rel_l2(a, b) <= lim
    # the weight gradient is deterministic (fixed-order block partials)
    fp = t_ngp.field_params(params, cfg)
    w = t_ngp._kernel_widths(params, cfg)
    mma = fp.get("mlp_mma")
    once = t_ngp.field_heads_bwd(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb, mma)
    again = t_ngp.field_heads_bwd(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb, mma)
    assert torch.equal(once[1], again[1]) and torch.equal(once[0], again[0])
    assert torch.equal(once[0], grads[0][0])


def test_wrappers_raise_instead_of_falling_back(cuda):
    occ = torch.zeros((1, 128, 128, 128), dtype=torch.bool, device=cuda)
    o = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        t_march.march_rays_aabb(o, torch.ones((3, 8), device=cuda).t(), (-1, -1, -1, 1, 1, 1),
                                occ, min_near=0.2, bound=1.0)
    with pytest.raises(NotImplementedError, match="bool occupancy"):
        t_march.march_rays_aabb(o, o + 1, (-1, -1, -1, 1, 1, 1), occ.float(),
                                min_near=0.2, bound=1.0)


@pytest.mark.parametrize("F", [1, 2, 8])
@pytest.mark.parametrize("gather", [torch.bfloat16, torch.float32])
def test_msg_table_kernel_matches_plain(cuda, gather, F):
    from nerf_signature_tpu_torch.models import message as t_msg

    g = torch.Generator().manual_seed(9)
    D = 32
    tables = t_msg.init_msg_tables(g, D, F, 19, cuda)
    bits = torch.randint(0, 2, (D,), generator=g, dtype=torch.int32).to(cuda)
    k_eff, k_g = t_msg.effective_table(tables, bits, gather)
    p_eff, p_g = t_msg.effective_table(tables, bits, gather, plain=True)
    assert torch.equal(k_eff, p_eff) and torch.equal(k_g, p_g) and k_g.dtype == gather
    g_eff = torch.randn(k_eff.shape, generator=g).to(cuda)
    grads = []
    for plain in (False, True):
        t = tables.clone().requires_grad_(True)
        t_msg.effective_table(t, bits, gather, plain=plain)[0].backward(g_eff)
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_field_bwd_feat_kernel_matches_plain(cuda, dtype, widths):
    from nerf_signature_tpu_torch.ops import _cuda

    kw = WIDTHS[widths]
    cfg = t_ngp.NGPConfig(compute_dtype=dtype, **kw)
    params = t_ngp.init_ngp_params(torch.Generator().manual_seed(10), cfg, cuda)
    params["hash_table"].mul_(1e4)
    fp = t_ngp.field_params(params, cfg)
    g = torch.Generator().manual_seed(11)
    M = 100_003  # not a multiple of the 32-sample warp tile
    x = (torch.rand((M, 3), generator=g) * 2 - 1).to(cuda)
    d = torch.nn.functional.normalize(torch.randn((M, 3), generator=g), dim=-1).to(cuda)
    with torch.no_grad():
        feat = t_ngp._encode_pos(fp, cfg, x)
    g_sigma = (torch.randn(M, generator=g) * 1e-3).to(cuda)
    g_rgb = (torch.randn((M, 3), generator=g) * 1e-3).to(cuda)
    g_sigma[::5] = 0.0
    g_rgb[::5] = 0.0
    g_sigma[:64] = 0.0  # two whole warp tiles with zero cotangents
    g_rgb[:64] = 0.0
    w = t_ngp._kernel_widths(params, cfg)
    only = t_ngp.field_heads_bwd_feat(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb,
                                      fp.get("mlp_mma"))
    assert not bool(only[:64].any())
    full = t_ngp.field_heads_bwd(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb,
                                 fp.get("mlp_mma"))[0]
    assert torch.equal(only, full)
    # through autograd with frozen weights: the feature-only kernel runs
    _cuda.reset_launch_counts()
    f = feat.clone().requires_grad_(True)
    sigma, _, rgb = t_ngp.field_heads(fp, cfg, f, d)
    torch.autograd.backward([sigma, rgb], [g_sigma, g_rgb])
    assert torch.equal(f.grad, only)
    route = "K4_field_bwd_feat" if dtype == torch.bfloat16 else "K4_field_bwd_feat_f32"
    counts = _cuda.launch_counts()
    assert counts[route] == 1 and counts["K4_field_bwd"] + counts["K4_field_bwd_f32"] == 0
    fp_ = feat.clone().requires_grad_(True)
    sp, _, rp = t_ngp.field_heads_plain(fp, cfg, fp_[:, :cfg.enc_dim], d)
    torch.autograd.backward([sp, rp], [g_sigma, g_rgb])
    assert rel_l2(only, fp_.grad) <= (1e-5 if dtype == torch.float32 else 1e-2)


def test_table_gather_kernel_matches_plain(cuda):
    from nerf_signature_tpu_torch.ops import gather as t_gather

    g = torch.Generator().manual_seed(12)
    table = torch.rand(1 << 19, generator=g).to(cuda)
    idx = torch.randint(0, 1 << 19, (524_288,), generator=g, dtype=torch.int32).to(cuda)
    out = t_gather.table_gather(table, idx)
    assert torch.equal(out, t_gather.table_gather_plain(table, idx))
    assert torch.equal(out, torch.take(table, idx.long()))


@pytest.mark.parametrize("offsets", [(0, 0), (1, 2), (3, 1), (2, 0), (0, 3)])
@pytest.mark.parametrize("n", [1, 3, 5, 524_291])
def test_table_gather_kernel_any_view(cuda, n, offsets):
    """One launch for any N and any 4-byte aligned start of idx and out:
    the scalar head and tail around the 4-wide body, and the body's scalar
    stores when out's alignment differs from idx's."""
    from nerf_signature_tpu_torch.ops import gather as t_gather

    g = torch.Generator().manual_seed(14)
    table = torch.rand(1 << 19, generator=g).to(cuda)
    oi, oo = offsets
    idx_buf = torch.randint(0, 1 << 19, (n + 4,), generator=g, dtype=torch.int32).to(cuda)
    out_buf = torch.full((n + 4,), -1.0, device=cuda)
    idx, out = idx_buf[oi:oi + n], out_buf[oo:oo + n]
    assert (idx.data_ptr() % 16 != 0) == (oi != 0) and (out.data_ptr() % 16 != 0) == (oo != 0)
    res = t_gather.table_gather(table, idx, out=out)
    assert res.data_ptr() == out.data_ptr()
    assert torch.equal(out, table[idx.long()])
    assert bool((out_buf[:oo] == -1).all()) and bool((out_buf[oo + n:] == -1).all())


@pytest.mark.parametrize("shared", [False, True])
def test_hash_encode_kernel_one_level_and_shared_table(cuda, shared):
    """K1 as the message feature calls it: one level at resolution 2048 on
    a 2^19-row table, or every level on one shared table (hash_select 0)."""
    g = torch.Generator().manual_seed(13)
    res = t_hash.level_resolutions(16, 16, 2048) if shared else np.array([2048.0])
    table = (torch.rand((1 << 19, 2), generator=g) * 2 - 1).to(cuda)
    x = torch.rand((1 << 16, 3), generator=g).to(cuda)
    for gd in (torch.bfloat16, None):
        k = t_hash.hash_encode(x, table, res, 19, gather_dtype=gd, shared_table=shared)
        p = t_hash.hash_encode_plain(x, table, res, 19, gather_dtype=gd, shared_table=shared)
        torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-7)
    g_feat = torch.randn((1 << 16, len(res) * 2), generator=g).to(cuda)
    k = t_hash._hash_encode_bwd_kernel(x, g_feat, 1 << 19, res, 19, torch.bfloat16, shared,
                                       None)
    p = t_hash.hash_encode_bwd_plain(x, g_feat, 1 << 19, res, 19, torch.bfloat16,
                                     shared_table=shared)
    assert rel_l2(k, p) <= 1e-5


@pytest.mark.parametrize("gather", ["bf16", "fp32", "dense"])
@pytest.mark.parametrize("L,F", [(16, 2), (8, 2), (8, 4), (16, 4), (32, 2), (5, 2),
                                 (5, 4), (24, 1), (5, 1), (8, 8), (5, 8)])
def test_hash_encode_kernel_is_bit_exact(cuda, L, F, gather):
    """The level-major forward: equal to the plain version bit for bit, for
    rows of 1, 2, 4 and 8 features, at 16 x 4 and at 32 x 2
    (NGP_MAX_LEVELS), odd level counts (8-byte stores at F = 2, 4-byte ones
    at F = 1) and a ragged last tile; its backward within 1e-5 relative L2
    (atomic order)."""
    g = torch.Generator().manual_seed(15)
    res = t_hash.level_resolutions(L, 16, 2048)
    sides = t_hash.level_sides(res, 19, True) if gather == "dense" else None
    rows = int(t_hash.level_row_counts(sides, 19).sum()) if sides else L << 19
    table = (torch.rand((rows, F), generator=g) * 2 - 1).to(cuda)
    M = (1 << 16) + 77  # not a multiple of the 128-sample tile
    x = (torch.rand((M, 3), generator=g) * 1.1 - 0.05).to(cuda)
    x[: M // 4] = 0.5  # padded slots: one point
    gd = torch.float32 if gather == "fp32" else torch.bfloat16
    tg = table.to(gd)
    k = t_hash._hash_encode_kernel(x, tg, rows, res, 19, False, sides)
    p = t_hash.hash_encode_plain(x, table, res, 19, dense_sides=sides, table_g=tg)
    assert k.shape == (M, L * F) and torch.equal(k, p)
    g_feat = torch.randn((M, L * F), generator=g).to(cuda)
    g_feat[::3] = 0.0
    kb = t_hash._hash_encode_bwd_kernel(x, g_feat, rows, res, 19, gd, False, sides)
    pb = t_hash.hash_encode_bwd_plain(x, g_feat, rows, res, 19, gd, dense_sides=sides)
    assert rel_l2(kb, pb) <= 1e-5


@pytest.mark.parametrize("bound,gamma,group,group_budget,noise", [
    (1.0, 0.0, 4, 8, False), (1.0, 0.0, 4, 8, True), (2.0, 1 / 128, 4, 4, False),
    (2.0, 1 / 128, 4, 4, True), (1.0, 0.0, 3, 10, False), (2.0, 1 / 128, 16, 3, False)])
def test_march_kernel_group_budget_and_group_sizes_match_plain(cuda, bound, gamma, group,
                                                               group_budget, noise):
    """The warp walk's prefilter with a group budget that truncates and
    groups that do not divide 32 (or fill half a warp), bit for bit."""
    rng = np.random.default_rng(16)
    C = 1 if bound <= 1 else 2
    occ = torch.tensor(rng.uniform(size=(C, 128, 128, 128)) < 0.05).to(cuda)
    o, d = (v.to(cuda) for v in _rays(rng, 4096, bound))
    nz = torch.rand(4096, generator=torch.Generator().manual_seed(17)).to(cuda) if noise else None
    aabb = (-bound,) * 3 + (bound,) * 3
    kw = dict(min_near=0.2, bound=bound, dt_gamma=gamma, max_steps=1024, budget=128,
              prefilter=True, group=group, group_budget=group_budget, noise=nz,
              n_cand=1020 if group == 3 else None)
    k = t_march.march_rays_aabb(o, d, aabb, occ, **kw)
    p = t_march.march_rays_aabb(o, d, aabb, occ, plain=True, **kw)
    assert k["mask"].any() and (p["n_groups_occ"] > group_budget).any()
    for name in p:
        assert torch.equal(k[name], p[name]), name


@pytest.mark.parametrize("T_thresh", [0.0, 1e-4])
@pytest.mark.parametrize("mask_kind", ["on", "off", "all_masked"])
@pytest.mark.parametrize("S", [1, 31, 32, 40, 256])
def test_composite_kernels_edge_cases(cuda, S, mask_kind, T_thresh):
    """K3 (one warp a ray, chunks of 32) at S not a multiple of 32, stops
    inside the first chunk and at its boundary, all-masked rays, no mask and
    T_thresh = 0: forward within 1e-5, backward within 1e-5 relative L2 with
    bit-equal repeats (no atomics)."""
    N = 515  # not a multiple of the block's 4 rays
    sig, rgb, dt, ts, mask = (None if v is None else torch.from_numpy(v).to(cuda)
                              for v in k3_edge_inputs(N, S, mask_kind))
    k = t_comp.composite_rays(sig, rgb, dt, ts, mask=mask, T_thresh=T_thresh)
    p = t_comp.composite_rays_plain(sig, rgb, dt, ts, mask=mask, T_thresh=T_thresh)
    for name in k:
        assert float((k[name] - p[name]).abs().max()) <= 1e-5, name
    g = torch.Generator(device=cuda).manual_seed(9)
    cts = [torch.randn(shape, generator=g, device=cuda) for shape in ((N,), (N,), (N, 3), (N, S))]
    once = t_comp.composite_rays_bwd(sig, rgb, dt, ts, mask, T_thresh, *cts)
    again = t_comp.composite_rays_bwd(sig, rgb, dt, ts, mask, T_thresh, *cts)
    assert torch.equal(once[0], again[0]) and torch.equal(once[1], again[1])
    s_, r_ = sig.clone().requires_grad_(True), rgb.clone().requires_grad_(True)
    out = t_comp.composite_rays_plain(s_, r_, dt, ts, mask=mask, T_thresh=T_thresh)
    gs_p, gr_p = torch.autograd.grad([out[n] for n in ("weights_sum", "depth", "image",
                                                       "weights")], [s_, r_], cts)
    if mask_kind == "all_masked":
        assert not once[0].any() and not once[1].any() and not k["weights"].any()
        return
    assert rel_l2(once[0], gs_p) <= 1e-5 and rel_l2(once[1], gr_p) <= 1e-5
    if T_thresh > 0 and S > 32:  # the stops: at slot 1, 31 and 32
        w = k["weights"]
        assert not w[0, 1:].any() and not w[1, 31:].any() and not w[2, 32:].any()
        assert bool((w[:3, 0] > 0).all())


@pytest.mark.parametrize("N,S", [(0, 64), (7, 1), (3, 0)])
def test_composite_kernels_empty_and_tiny(cuda, N, S):
    g = torch.Generator(device=cuda).manual_seed(10)
    sig = torch.rand((N, S), generator=g, device=cuda) * 5
    rgb = torch.rand((N, S, 3), generator=g, device=cuda)
    dt = torch.full((N, S), 0.01, device=cuda)
    ts = torch.cumsum(dt, -1)
    k = t_comp.composite_rays(sig, rgb, dt, ts)
    p = t_comp.composite_rays_plain(sig, rgb, dt, ts)
    for name in k:
        assert k[name].shape == p[name].shape
        torch.testing.assert_close(k[name], p[name], rtol=1e-5, atol=1e-5)
    cts = (torch.ones((N,), device=cuda), None, torch.ones((N, 3), device=cuda), None)
    gs, gr = t_comp.composite_rays_bwd(sig, rgb, dt, ts, None, 1e-4, *cts)
    assert gs.shape == (N, S) and gr.shape == (N, S, 3) and bool(torch.isfinite(gs).all())


@pytest.mark.parametrize("L,F,pitch", [(12, 2, 32), (24, 1, 32), (6, 8, 64), (5, 1, 8)])
def test_hash_encode_kernels_at_a_padded_pitch(cuda, L, F, pitch):
    """K1 writing K4's built input width: the first L*F columns equal to
    the plain version bit for bit, the rest exactly 0; the backward reads
    the same pitch and ignores what the padded columns hold."""
    g = torch.Generator().manual_seed(16)
    res = t_hash.level_resolutions(L, 16, 2048)
    rows = L << 19
    table = (torch.rand((rows, F), generator=g) * 2 - 1).to(cuda)
    M = (1 << 16) + 77
    x = torch.rand((M, 3), generator=g).to(cuda)
    tg = table.to(torch.bfloat16)
    k = t_hash._hash_encode_kernel(x, tg, rows, res, 19, False, None, pitch)
    p = t_hash.hash_encode_plain(x, table, res, 19, table_g=tg)
    assert k.shape == (M, pitch) and torch.equal(k[:, :L * F], p)
    assert not bool(k[:, L * F:].any())
    g_feat = torch.randn((M, pitch), generator=g).to(cuda)
    g_feat[::3] = 0.0
    kb = t_hash._hash_encode_bwd_kernel(x, g_feat, rows, res, 19, torch.bfloat16, False, None, F)
    pb = t_hash.hash_encode_bwd_plain(x, g_feat[:, :L * F].contiguous(), rows, res, 19,
                                      torch.bfloat16)
    assert rel_l2(kb, pb) <= 1e-5
    # through autograd
    tt = torch.zeros((rows, F), device=cuda, requires_grad=True)
    feat = t_hash.hash_encode(x, tt, res, 19, gather_dtype=torch.bfloat16, table_g=tg,
                              pitch=pitch)
    assert feat.shape == (M, pitch)
    feat.backward(g_feat)
    assert rel_l2(tt.grad, pb) <= 1e-5


@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_hash_encode_bwd_kernel_edge_cases(cuda, F):
    """M = 0; all-zero cotangents (every warp task skipped: the gradient
    exactly 0); the message's shape, one level at resolution 2048 on 2^19
    rows, with live samples in runs like a ray's and a ragged end; the
    shared table of every level (hash_select 0)."""
    g = torch.Generator().manual_seed(17)
    res16 = t_hash.level_resolutions(16, 16, 2048)
    x0 = torch.zeros((0, 3), device=cuda)
    out = t_hash._hash_encode_bwd_kernel(x0, torch.zeros((0, 16 * F), device=cuda), 1 << 10,
                                         res16, 10, torch.bfloat16, False, None)
    assert out.shape == (1 << 10, F) and not bool(out.any())
    M = 100_003
    x = torch.rand((M, 3), generator=g).to(cuda)
    zero = t_hash._hash_encode_bwd_kernel(x, torch.zeros((M, 16 * F), device=cuda), 16 << 19,
                                          res16, 19, torch.bfloat16, False, None)
    assert not bool(zero.any())
    one = np.array([2048.0])
    g1 = torch.randn((M, F), generator=g).to(cuda)
    g1[(torch.arange(M, device=cuda) % 256) >= 120] = 0.0  # a ray's dead slots
    for gd in (torch.bfloat16, torch.float32):
        k = t_hash._hash_encode_bwd_kernel(x, g1, 1 << 19, one, 19, gd, False, None)
        p = t_hash.hash_encode_bwd_plain(x, g1, 1 << 19, one, 19, gd)
        assert rel_l2(k, p) <= 1e-5
    gs = torch.randn((M, 16 * F), generator=g).to(cuda)
    gs[::4] = 0.0
    k = t_hash._hash_encode_bwd_kernel(x, gs, 1 << 19, res16, 19, torch.bfloat16, True, None)
    p = t_hash.hash_encode_bwd_plain(x, gs, 1 << 19, res16, 19, torch.bfloat16,
                                     shared_table=True)
    assert rel_l2(k, p) <= 1e-5


@pytest.mark.parametrize("D,T,F", [(1, 1001, 1), (40, 1023, 2), (3, 1 << 10, 8), (33, 5, 4)])
def test_msg_table_bwd_kernel_any_shape(cuda, D, T, F):
    """K9's backward equal to its plain version where T * F is not a
    multiple of 4 (one entry a thread), with more than 32 bits (two words
    of the staged mask) and at F = 8 (16-byte loads and stores)."""
    from nerf_signature_tpu_torch.models import message as t_msg

    g = torch.Generator().manual_seed(19)
    bits = torch.randint(0, 2, (D,), generator=g, dtype=torch.int32).to(cuda)
    g_eff = torch.randn((T, F), generator=g).to(cuda)
    k = t_msg._msg_table_bwd_kernel(g_eff, bits, D)
    assert torch.equal(k, t_msg.msg_table_bwd_plain(g_eff, bits, D))


@pytest.mark.parametrize("hash_select", [0, 1])
def test_message_feature_at_a_padded_width(cuda, hash_select):
    """12 x 2 (width 24, K4 at 32): the watermarked field through the
    kernels, the message feature added at the backbone's pitch (every level
    through the shared table, or the finest level's), against the plain
    versions in fp32 (1e-5)."""
    from nerf_signature_tpu_torch.models import watermark as t_wm

    wcfg = t_wm.WatermarkConfig(ngp=t_ngp.NGPConfig(compute_dtype=torch.float32, n_levels=12),
                                message_dim=4, hash_select=hash_select)
    p = t_wm.init_watermark_params(torch.Generator().manual_seed(20), wcfg, cuda)
    p["backbone"]["hash_table"].mul_(1e4)
    p["trainable"]["msg_tables"].mul_(1e3)
    g = torch.Generator().manual_seed(21)
    M = 50_001
    x = (torch.rand((M, 3), generator=g) * 2 - 1).to(cuda)
    d = torch.nn.functional.normalize(torch.randn((M, 3), generator=g), dim=-1).to(cuda)
    out = []
    for plain in (False, True):
        fp = t_wm.wtmk_field_params(p["backbone"], p["trainable"], wcfg, [0, 1, 1, 0], plain)
        out.append(t_wm.wtmk_field(fp, wcfg, x, d, plain))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
