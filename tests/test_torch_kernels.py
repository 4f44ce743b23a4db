"""The port's CUDA kernels (K1-K4 forward and backward, K9 forward and
backward, the feature-only K4 backward, P1, K5, K7 and K8) against their
plain PyTorch versions on the same inputs, on the card.  Skipped where no
GPU is visible.

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
repeats); K4's tiled fp32 forward and feature-only backward at every built
width at 1, a tile less one, a tile and one, and 4097 samples (the forward
with and without dirs, geo and the logit, each launch's outputs bit-equal
to the full one's; the backward on chunks that mix live samples with
all-zero cotangents and on all-zero chunks, which write 0); P1 equals
``table[idx]`` for any N and unaligned views.  K1 is also held at rows of
1 and 8 features, at a padded output pitch (the columns past L*F exactly 0;
the backward reads the same pitch) and on its backward's edges (M = 0, all-zero cotangents, one level of 2^19 rows, the
shared table); K4 at encoding widths 24 and 48 (run at 32 and 64); K9's
backward at any T * F and more than 32 bits.  K3 is
also held at its warp walk's edges (S not a multiple of the 32-slot chunk,
stops inside the first chunk and at its boundary, the mask absent or all
off, T_thresh 0, N = 0), its backward repeats bit-equal (no atomics).
K2 on the float render grid (the transmittance cull) against its plain
version: bit for bit at t_cull 0, and with the cull on every ray that no
candidate puts at the cull's margin (none on the inputs); the device loop
with --t_cull captures its step again once, when the fog gate opens, and
then launches the cull route every step.
K5 (sample compaction) pack, unpack and unpack backward bit for bit
against the plain versions on ``kernel_cases.k5_edge_inputs`` and at the
clean and watermark steps' shapes; the unpack also on its tiles' edges
(M below a tile, ragged, 0, nothing and everything kept, a cap, an
unaligned slot map), its backward on its own (a ragged Mc with empty
slots at the tail, a tile's edge, all slots empty, an unaligned map, the
outputs views of one allocation); the pack also on a mask one byte off its
alignment, repeated (its look-back's order), with a cap (a data-parallel rank's
share of the global budget), and captured in a CUDA graph and replayed
on other masks (its scratch reset); a clean step captured as a CUDA
graph and replayed against the same steps run eagerly (1e-5: K1's
atomics).
K7's one-corner forward bit for bit (the same corner choice) at every
row width, pitch and addressing, and at two geometries called in turns;
its backward within 1e-6 relative L2 (atomic order) touching the same
rows, at level strides 1, 2 and 3 (3 runs at 1), and on the edges of its
live lists (a tile with no live row, rows live at some levels, M not a
multiple of its tile, stride 4) and refusing a tile it cannot take;
K8 on given positions bit for bit (backward 1e-5), and from the rays within
1e-3 (atan2f's ulps at resolution 2048) with the rays at phi's branch cut
left out; K8 as the whole background colour (``-k bg``) against the plain
chain at F = 1, 2, 4 and 8 in fp32 (1e-3) and bf16 (relative L1 limits
between the kernel's reading and a control's, which they refuse), its
backward bit-equal over repeats and graph replays, one launch each way
through autograd.
"""

import numpy as np
import pytest
import torch

from nerf_signature_tpu_torch.kernel_cases import k3_edge_inputs, k5_edge_inputs
from nerf_signature_tpu_torch.models import ngp as t_ngp
from nerf_signature_tpu_torch.ops import background as t_bg
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


def _density_grid(rng, C, H=128):
    """A float render grid: densities U(0, 300) on 5% of the cells, a few
    of them at exactly 0 (occupied in the bool grid, empty here)."""
    occ = rng.uniform(size=(C, H, H, H)) < 0.05
    dens = rng.uniform(0.0, 300.0, size=occ.shape) * (rng.uniform(size=occ.shape) > 0.05)
    return torch.tensor(np.where(occ, dens, 0.0).astype(np.float32))


@pytest.mark.parametrize("t_cull", [1e-3, 1e-5, 0.0])
@pytest.mark.parametrize("bound,prefilter,gamma", [
    (b, pf, g) for b in (1.0, 2.0) for pf in (True, False) for g in (0.0, 1 / 128)])
def test_march_cull_kernel_matches_plain(cuda, bound, prefilter, gamma, t_cull):
    """K2 on the float render grid: with the cull, equal to the plain
    version on every ray but those at the cull's margin (a candidate's
    entering transmittance within CULL_MARGIN of t_cull: the warp scan adds
    tau in another order than torch.cumsum), which are counted and must be
    none here; at t_cull 0 bit for bit."""
    rng = np.random.default_rng(5)
    C = 1 if bound <= 1 else 2
    grid = _density_grid(rng, C).to(cuda)
    o, d = (v.to(cuda) for v in _rays(rng, 4096, bound))
    nz = torch.rand(4096, generator=torch.Generator().manual_seed(6)).to(cuda)
    aabb = (-bound,) * 3 + (bound,) * 3
    kw = dict(min_near=0.2, bound=bound, dt_gamma=gamma, max_steps=1024, budget=128,
              prefilter=prefilter, noise=nz, t_cull=t_cull)
    k = t_march.march_rays_aabb(o, d, aabb, grid, **kw)
    p = t_march.march_rays_aabb(o, d, aabb, grid, plain=True, audit=True, **kw)
    margin = p.pop("cull_margin", torch.zeros(4096, dtype=torch.bool, device=cuda))
    p.pop("n_tested")
    assert int(margin.sum()) == 0
    assert k["mask"].any()
    if t_cull > 0:
        assert (p["n_occupied"] < p["n_occupied_raw"]).any()
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
    one over queued live samples (field_bwd.cu)."""
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
    # padded samples carry zero cotangents; the fp32 kernel queues only the
    # live samples
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
    # the marcher takes the bool grid or the float32 render grid, nothing else
    with pytest.raises(TypeError, match="float64"):
        t_march.march_rays_aabb(o, o + 1, (-1, -1, -1, 1, 1, 1), occ.double(),
                                min_near=0.2, bound=1.0)
    with pytest.raises(ValueError, match="t_cull"):
        t_march.march_rays_aabb(o, o + 1, (-1, -1, -1, 1, 1, 1), occ, min_near=0.2,
                                bound=1.0, t_cull=1e-3)


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


# K4's tiled SIMT kernels (fp32) at every built width, at sample counts
# around their tiles (models/ngp.py:SIMT_TILE): one sample, a tile less one
# and plus one, and 4097
SIMT_WIDTHS = ["full", "8x2", "16x4", "narrow"]
RAGGED = {"1": lambda T: 1, "T-1": lambda T: T - 1, "T+1": lambda T: T + 1,
          "4097": lambda T: 4097}


def _simt_case(cuda, widths, M, seed):
    cfg = t_ngp.NGPConfig(compute_dtype=torch.float32, **WIDTHS[widths])
    params = t_ngp.init_ngp_params(torch.Generator().manual_seed(seed), cfg, cuda)
    params["hash_table"].mul_(1e4)
    fp = t_ngp.field_params(params, cfg)
    g = torch.Generator().manual_seed(seed + 1)
    x = (torch.rand((M, 3), generator=g) * 2 - 1).to(cuda)
    d = torch.nn.functional.normalize(torch.randn((M, 3), generator=g), dim=-1).to(cuda)
    with torch.no_grad():
        feat = t_ngp._encode_pos(fp, cfg, x)
    return cfg, fp, feat, d, g


@pytest.mark.parametrize("case", list(RAGGED))
@pytest.mark.parametrize("widths", SIMT_WIDTHS)
def test_field_simt_forward_ragged(cuda, widths, case):
    """The tiled fp32 forward with dirs, geo and the logit against its
    plain version (1e-5); without geo and the logit, and the density-only
    query (no dirs), bit-equal to that launch's sigma, geo and rgb."""
    from nerf_signature_tpu_torch.ops import _cuda

    M = RAGGED[case](t_ngp.SIMT_TILE["fwd"])
    cfg, fp, feat, d, _ = _simt_case(cuda, widths, M, 20)
    _cuda.reset_launch_counts()
    s, geo, rgb, raw = t_ngp.field_heads(fp, cfg, feat, d, want_geo=True, want_raw=True)
    assert _cuda.launch_counts()["K4_field_raw_f32"] == 1
    sp, gp, rp, rawp = t_ngp.field_heads_plain(fp, cfg, feat[:, :cfg.enc_dim], d, want_raw=True)
    for a, b in ((s, sp), (geo, gp), (rgb, rp), (raw, rawp)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    s1, g1, r1 = t_ngp.field_heads(fp, cfg, feat, d)
    assert g1 is None and torch.equal(s1, s) and torch.equal(r1, rgb)
    s2, g2, r2 = t_ngp.field_heads(fp, cfg, feat, None, want_geo=True)
    assert r2 is None and torch.equal(s2, s) and torch.equal(g2, geo)
    s3, g3, r3 = t_ngp.field_heads(fp, cfg, feat, None)
    assert g3 is None and r3 is None and torch.equal(s3, s)
    assert _cuda.launch_counts()["K4_field_f32"] == 3


@pytest.mark.parametrize("case", list(RAGGED))
@pytest.mark.parametrize("widths", SIMT_WIDTHS)
def test_field_simt_bwd_feat_ragged_and_zero_tiles(cuda, widths, case):
    """The tiled feature-only backward: the first chunk of a tile's
    samples mixes live samples with all-zero cotangents, the second (or
    the ragged one sample past the first) is all zero; g_feat bit-equal to
    the full backward's, exactly 0 where the cotangents are, within 1e-5
    relative L2 of autograd through the plain version; all cotangents
    zero: g_feat all 0."""
    from nerf_signature_tpu_torch.ops import _cuda

    T = t_ngp.SIMT_TILE["bwd_feat"]
    M = RAGGED[case](T)
    cfg, fp, feat, d, g = _simt_case(cuda, widths, M, 22)
    g_sigma = (torch.randn(M, generator=g) * 1e-3).to(cuda)
    g_rgb = (torch.randn((M, 3), generator=g) * 1e-3).to(cuda)
    i = torch.arange(M, device=cuda)
    dead = (i % 3 == 1) | ((i >= T) & (i < 2 * T))
    g_sigma[dead], g_rgb[dead] = 0.0, 0.0
    w = t_ngp._kernel_widths(fp, cfg)
    _cuda.reset_launch_counts()
    only = t_ngp.field_heads_bwd_feat(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb)
    assert _cuda.launch_counts()["K4_field_bwd_feat_f32"] == 1
    full = t_ngp.field_heads_bwd(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb)[0]
    assert torch.equal(only, full)
    assert not bool(only[dead].any())
    f = feat.clone().requires_grad_(True)
    sp, _, rp = t_ngp.field_heads_plain(fp, cfg, f[:, :cfg.enc_dim], d)
    torch.autograd.backward([sp, rp], [g_sigma, g_rgb])
    assert rel_l2(only, f.grad) <= 1e-5
    zero = t_ngp.field_heads_bwd_feat(cfg, w, feat, d, fp["mlp_flat"], g_sigma * 0, g_rgb * 0)
    assert not bool(zero.any())


@pytest.mark.parametrize("case", list(RAGGED))
@pytest.mark.parametrize("widths", SIMT_WIDTHS)
def test_field_simt_bwd_ragged_and_dead_chunks(cuda, widths, case):
    """The tiled full backward over queued live samples: the first chunk
    mixes live samples with all-zero cotangents, the second (or the ragged
    one sample past the first) is all dead; g_feat bit-equal to the
    feature-only kernel's and exactly 0 on the dead samples, g_feat and the
    five weight leaves within 1e-5 relative L2 of autograd through the
    plain version, a repeat bit-equal; with 3 live samples (fewer than the
    blocks) the same; all cotangents zero: both gradients all 0."""
    from nerf_signature_tpu_torch.ops import _cuda

    T = t_ngp.SIMT_TILE["bwd"]
    M = RAGGED[case](T)
    cfg, fp, feat, d, g = _simt_case(cuda, widths, M, 24)
    w = t_ngp._kernel_widths(fp, cfg)
    i = torch.arange(M, device=cuda)
    for dead in ((i % 3 == 1) | ((i >= T) & (i < 2 * T)), ~torch.isin(i, i[[0, M // 2, -1]])):
        g_sigma = (torch.randn(M, generator=g) * 1e-3).to(cuda)
        g_rgb = (torch.randn((M, 3), generator=g) * 1e-3).to(cuda)
        g_sigma[dead], g_rgb[dead] = 0.0, 0.0
        _cuda.reset_launch_counts()
        gf, gw = t_ngp.field_heads_bwd(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb)
        assert _cuda.launch_counts()["K4_field_bwd_f32"] == 1
        only = t_ngp.field_heads_bwd_feat(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb)
        assert torch.equal(gf, only) and not bool(gf[dead].any())
        again = t_ngp.field_heads_bwd(cfg, w, feat, d, fp["mlp_flat"], g_sigma, g_rgb)
        assert torch.equal(again[0], gf) and torch.equal(again[1], gw)
        nets = [x.clone().requires_grad_(True) for x in fp["sigma_net"] + fp["color_net"]]
        pp = dict(fp, sigma_net=nets[:2], color_net=nets[2:])
        f = feat.clone().requires_grad_(True)
        sp, _, rp = t_ngp.field_heads_plain(pp, cfg, f[:, :cfg.enc_dim], d)
        torch.autograd.backward([sp, rp], [g_sigma, g_rgb])
        assert rel_l2(gf, f.grad) <= 1e-5
        W, IN, hid = cfg.enc_dim, w[0], w[1]
        assert not bool(gw[W * hid:IN * hid].any())  # Ws0's padded rows
        gw_w = torch.cat([gw[:W * hid], gw[IN * hid:]])
        for a, b in zip(torch.split(gw_w, [x.numel() for x in nets]), nets):
            assert rel_l2(a, b.grad.reshape(-1)) <= 1e-5
    gf, gw = t_ngp.field_heads_bwd(cfg, w, feat, d, fp["mlp_flat"], g_sigma * 0, g_rgb * 0)
    assert not bool(gf.any()) and not bool(gw.any())


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


# ------------------------------------------------------------------ K5
K5_CASES = [c[0] for c in k5_edge_inputs()]


def _k5_check(cuda, mask, xyzs, rd, Mc, sig_c, rgb_c, g_sig, g_rgb):
    """K5's pack, unpack and unpack backward against the plain versions:
    bit-exact (every value is a copy)."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    args = [torch.as_tensor(v) for v in (mask, xyzs, rd)]
    plain = t_compact.compact_plain(*args, Mc)
    comp = t_compact.compact(*(a.to(cuda) for a in args), Mc)
    so, sa = t_compact.slot_maps_plain(plain)
    for a, b in ((comp.xyz_c, plain.xyz_c), (comp.dir_c, plain.dir_c),
                 (comp.slot_of, so), (comp.sample_of, sa)):
        assert torch.equal(a.cpu(), b)
    leaves = [torch.as_tensor(v).requires_grad_() for v in (sig_c, rgb_c)]
    s, r = t_compact.uncompact_plain(*leaves, plain)
    kl = [t.detach().to(cuda).requires_grad_() for t in leaves]
    sk, rk = t_compact.uncompact(*kl, comp)
    assert torch.equal(sk.detach().cpu(), s.detach()) and torch.equal(rk.detach().cpu(),
                                                                      r.detach())
    gs, gr = torch.as_tensor(g_sig), torch.as_tensor(g_rgb)
    if s.numel():
        ((s * gs).sum() + (r * gr).sum()).backward()
        ((sk * gs.to(cuda)).sum() + (rk * gr.to(cuda)).sum()).backward()
        assert torch.equal(kl[0].grad.cpu(), leaves[0].grad)
        assert torch.equal(kl[1].grad.cpu(), leaves[1].grad)


@pytest.mark.parametrize("name", K5_CASES)
def test_compact_kernels_edge_cases(cuda, name):
    case = {c[0]: c for c in k5_edge_inputs()}[name]
    _k5_check(cuda, *case[1:])


@pytest.mark.parametrize("N,S,frac", [(4096, 128, 0.25), (8704, 256, 0.5)])
def test_compact_kernels_at_the_step_shapes(cuda, N, S, frac):
    rng = np.random.default_rng(N)
    mask = rng.uniform(size=(N, S)) < 0.2
    mask[:, S // 2:] = False
    Mc = int(np.ceil(N * S * frac / 1024)) * 1024
    xyzs = np.where(mask[..., None], rng.uniform(-1, 1, (N, S, 3)), 0).astype(np.float32)
    _k5_check(cuda, mask, xyzs, rng.normal(size=(N, 3)).astype(np.float32), Mc,
              rng.normal(size=Mc).astype(np.float32), rng.uniform(size=(Mc, 3)).astype(np.float32),
              rng.normal(size=N * S).astype(np.float32),
              rng.normal(size=(N * S, 3)).astype(np.float32))


def _k5_step_inputs(cuda, N, S, seed):
    """A mask of rays whose samples are a prefix of their S slots (as K2
    writes them), positions zero where masked, directions."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = torch.randint(0, S + 1, (N, 1), generator=g, device=cuda)
    mask = torch.arange(S, device=cuda)[None] < n
    xyzs = torch.where(mask[..., None], torch.rand((N, S, 3), generator=g, device=cuda), 0.0)
    return mask, xyzs, torch.randn((N, 3), generator=g, device=cuda)


def _k5_pack_equal(comp, plain):
    from nerf_signature_tpu_torch.ops import compact as t_compact

    so, sa = t_compact.slot_maps_plain(plain)
    return all(torch.equal(a, b) for a, b in ((comp.xyz_c, plain.xyz_c),
                                              (comp.dir_c, plain.dir_c),
                                              (comp.slot_of, so), (comp.sample_of, sa)))


@pytest.mark.parametrize("name", K5_CASES)
def test_compact_pack_unaligned_mask(cuda, name):
    """The pack reads a mask one byte off its 16-byte alignment (scalar
    loads) bit for bit like the plain version."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    _, mask, xyzs, rd, Mc, *_ = {c[0]: c for c in k5_edge_inputs()}[name]
    buf = torch.zeros((mask.size + 1,), dtype=torch.bool, device=cuda)
    buf[1:] = torch.from_numpy(mask.reshape(-1)).to(cuda)
    m = buf[1:].view(mask.shape)
    x, r = torch.from_numpy(xyzs).to(cuda), torch.from_numpy(rd).to(cuda)
    assert _k5_pack_equal(t_compact.compact(m, x, r, Mc), t_compact.compact_plain(m, x, r, Mc))


@pytest.mark.parametrize("cap_share", [-0.5, 0.0, 0.3, 1.0, 1.5])
def test_compact_pack_with_a_cap(cuda, cap_share):
    """One data-parallel rank's pack: the kept samples capped by a device
    scalar (clamped to [0, Mc]), bit for bit like the plain version, the
    unpack and its backward through the capped maps too."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    mask, xyzs, rd = _k5_step_inputs(cuda, 4096, 128, 5)
    Mc = 131_072
    cap = torch.tensor(int(cap_share * Mc), dtype=torch.int64, device=cuda)
    comp = t_compact.compact(mask, xyzs, rd, Mc, cap=cap)
    plain = t_compact.compact_plain(mask, xyzs, rd, Mc, cap=cap)
    assert _k5_pack_equal(comp, plain)
    assert int(plain.keep.sum()) == min(int(mask.sum()), max(0, min(int(cap), Mc)))
    sig_c = torch.randn((Mc,), device=cuda, requires_grad=True)
    rgb_c = torch.rand((Mc, 3), device=cuda, requires_grad=True)
    sk, rk = t_compact.uncompact(sig_c, rgb_c, comp)
    sp, rp = t_compact.uncompact_plain(sig_c, rgb_c, plain)
    assert torch.equal(sk, sp) and torch.equal(rk, rp)
    g = torch.autograd.grad(sk.sum() + rk.sum(), (sig_c, rgb_c))
    gp = torch.autograd.grad(sp.sum() + rp.sum(), (sig_c, rgb_c))
    assert all(torch.equal(a, b) for a, b in zip(g, gp))


def test_compact_pack_repeats_bit_exact(cuda):
    """100 packs of one input at the watermark step's shape, each bit-equal to
    the plain version (a look-back that read out of order would show as a
    rare wrong offset)."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    mask, xyzs, rd = _k5_step_inputs(cuda, 8704, 256, 3)
    plain = t_compact.compact_plain(mask, xyzs, rd, 835_584)
    bad = sum(not _k5_pack_equal(t_compact.compact(mask, xyzs, rd, 835_584), plain)
              for _ in range(100))
    assert bad == 0


def test_compact_pack_graph_replays(cuda):
    """The pack captured once in a CUDA graph and replayed on three other
    masks copied into its inputs: bit-exact each time (its tile counter and
    status words start clean on every replay)."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    N, S, Mc = 4096, 128, 196_608
    inputs = list(_k5_step_inputs(cuda, N, S, 10))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        t_compact.compact(*inputs, Mc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        comp = t_compact.compact(*inputs, Mc)
    for seed in (11, 12, 13):
        new = _k5_step_inputs(cuda, N, S, seed)
        for dst, src in zip(inputs, new):
            dst.copy_(src)
        graph.replay()
        assert _k5_pack_equal(comp, t_compact.compact_plain(*new, Mc)), seed


# K5 unpack's tiles (1024 samples, csrc/compact.cu:UNPACK_TILE): name ->
# (N, S, share of samples set, Mc as a share of M, cap as a share of Mc or None)
K5_UNPACK_CASES = {"below_a_tile": (7, 100, 0.5, 0.5, None),
                   "ragged_tiles": (37, 29, 0.4, 0.5, None),    # M = 1073, not a multiple of 4
                   "m_zero": (0, 64, 0.5, 0.0, None),
                   "nothing_kept": (40, 128, 0.0, 0.25, None),
                   "everything_kept": (33, 128, 1.0, 1.0, None),
                   "cap": (96, 128, 0.6, 0.5, 0.3)}


@pytest.mark.parametrize("case", list(K5_UNPACK_CASES))
def test_compact_unpack_tiles(cuda, case):
    """K5 unpack against its plain version bit for bit, forward and through
    autograd, at M below one tile, M not a multiple of the tile (nor of 4:
    the rgb view's 16-byte offset), M = 0, nothing kept, everything kept,
    and a data-parallel cap; the slot map also one element off its 16-byte
    alignment (scalar reads).  The outputs are views of one buffer."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    N, S, on, mc_share, cap_share = K5_UNPACK_CASES[case]
    g = torch.Generator().manual_seed(N * S + 5)
    M = N * S
    Mc = int(M * mc_share)
    mask = (torch.rand((N, S), generator=g) < on).to(cuda)
    xyzs = torch.rand((N, S, 3), generator=g).to(cuda)
    rd = torch.randn((N, 3), generator=g).to(cuda)
    cap = None if cap_share is None else torch.tensor(int(cap_share * Mc), device=cuda)
    comp = t_compact.compact(mask, xyzs, rd, Mc, cap=cap)
    plain = t_compact.compact_plain(mask, xyzs, rd, Mc, cap=cap)
    kept = int(plain.keep.sum())
    assert kept == {"nothing_kept": 0, "everything_kept": M}.get(case, kept)
    sig_c = torch.randn((Mc,), generator=g).to(cuda).requires_grad_()
    rgb_c = torch.rand((Mc, 3), generator=g).to(cuda).requires_grad_()
    sp, rp = t_compact.uncompact_plain(sig_c, rgb_c, plain)
    with torch.no_grad():
        sk, rk = t_compact.uncompact(sig_c, rgb_c, comp)
    assert torch.equal(sk, sp) and torch.equal(rk, rp)
    assert sk.is_contiguous() and rk.is_contiguous() and rk.shape == (M, 3)
    assert rk.data_ptr() - sk.data_ptr() == 4 * (-(-M // 4) * 4)
    buf = torch.empty((M + 1,), dtype=torch.int32, device=cuda)
    buf[1:] = comp.slot_of
    su, ru = t_compact._unpack_kernel(sig_c.detach(), rgb_c.detach(), buf[1:])
    assert torch.equal(su, sp) and torch.equal(ru, rp)
    sk, rk = t_compact.uncompact(sig_c, rgb_c, comp)
    assert torch.equal(sk, sp) and torch.equal(rk, rp)
    if M:
        gs, gr = torch.randn((M,), generator=g).to(cuda), torch.randn((M, 3), generator=g).to(cuda)
        gk = torch.autograd.grad((sk * 2.0, rk), (sig_c, rgb_c), (gs, gr))
        gp = torch.autograd.grad((sp * 2.0, rp), (sig_c, rgb_c), (gs, gr))
        assert all(torch.equal(a, b) for a, b in zip(gk, gp))


# K5 unpack backward's tiles (1024 slots, gather_tile): name -> (Mc, kept)
K5_UNPACK_BWD_CASES = {"ragged_tail": (4099, 2500), "edge": (3072, 2048),
                       "edge_plus_one": (2049, 2049), "all_empty": (1027, 0),
                       "one_slot": (1, 1)}


@pytest.mark.parametrize("case", list(K5_UNPACK_BWD_CASES))
def test_compact_unpack_bwd_tiles(cuda, case):
    """K5's unpack backward bit for bit against the gather through
    ``sample_of`` (its plain version) and autograd's indexing_backward, at a
    ragged Mc with a tail of empty slots (-1), kept counts at a tile's edge
    and past it, and all slots empty; the map also one element off its
    16-byte alignment (scalar reads); the two outputs are contiguous views
    of one allocation, g_rgb_c at the first 16-byte boundary past g_sig_c."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    Mc, kept = K5_UNPACK_BWD_CASES[case]
    g = torch.Generator().manual_seed(Mc + kept)
    N, S = 64, 100
    mask = torch.zeros(N * S, dtype=torch.bool)
    mask[torch.randperm(N * S, generator=g)[:kept]] = True
    mask = mask.reshape(N, S).to(cuda)
    xyzs = torch.rand((N, S, 3), generator=g).to(cuda)
    rd = torch.randn((N, 3), generator=g).to(cuda)
    comp = t_compact.compact(mask, xyzs, rd, Mc)
    plain = t_compact.compact_plain(mask, xyzs, rd, Mc)
    assert int((comp.sample_of >= 0).sum()) == min(kept, Mc)
    gs, gr = torch.randn((N * S,), generator=g).to(cuda), torch.randn((N * S, 3),
                                                                       generator=g).to(cuda)
    ks, kr = t_compact.unpack_bwd(gs, gr, comp.sample_of)
    live = comp.sample_of >= 0
    src = comp.sample_of.clamp(min=0).long()
    assert torch.equal(ks, torch.where(live, gs[src], 0.0))
    assert torch.equal(kr, torch.where(live[:, None], gr[src], 0.0))
    assert ks.is_contiguous() and kr.is_contiguous() and kr.shape == (Mc, 3)
    assert kr.data_ptr() - ks.data_ptr() == 4 * (-(-Mc // 4) * 4)
    buf = torch.empty((Mc + 1,), dtype=torch.int32, device=cuda)
    buf[1:] = comp.sample_of
    us, ur = t_compact.unpack_bwd(gs, gr, buf[1:])
    assert torch.equal(us, ks) and torch.equal(ur, kr)
    leaves = [torch.randn((Mc,), generator=g).to(cuda).requires_grad_(),
              torch.rand((Mc, 3), generator=g).to(cuda).requires_grad_()]
    sp, rp = t_compact.uncompact_plain(*leaves, plain)
    gp = torch.autograd.grad((sp, rp), leaves, (gs, gr))
    assert torch.equal(ks, gp[0]) and torch.equal(kr, gp[1])


@pytest.mark.parametrize("C", [4, 3])
def test_captured_step_replays_match_eager(cuda, monkeypatch, C):
    """One clean step captured as a CUDA graph and replayed over two
    dispatches of 3 steps (the first: two warm-up steps, the capture, one
    replay; the second: three replays, the buffers reloaded) against the
    same six steps run eagerly, on the same draws, for RGBA images and for
    RGB ones (the white background a tensor the graph reads): fp32 losses
    and params within 1e-5 relative (K1's backward adds by atomics); the
    replays count their launches."""
    import types

    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from nerf_signature_tpu_torch.train import trainer as t_trainer

    rng = np.random.default_rng(0)
    P, H, W, N, k, n = 4, 64, 64, 1024, 3, 6
    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    poses[:, 2, 3] = 2.5
    poses[:, :3, :3] = np.diag([1.0, -1.0, -1.0])
    images = rng.uniform(size=(P, H, W, C)).astype(np.float32)
    intr = np.array([60.0, 60.0, 32.0, 32.0], np.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    draws = t_dl.draw_clean(gen, n, P, N, H * W, C == 4, cuda)
    runs = []
    for graph in (True, False):
        model = NGPModel(NGPConfig(bound=1.0, compute_dtype=torch.float32, **WIDTHS["narrow"]),
                         grid_size=32, train_budget=64, compact_frac=0.5, seed=2, device=cuda)
        model.params["hash_table"].data.mul_(1e4)
        opt = types.SimpleNamespace(lr=1e-2, iters=100, num_rays=N, max_steps=128,
                                    compact_frac=0.5, group_budget=0, update_extra_interval=16)
        tr = t_trainer.Trainer("ngp", opt, model, workspace=None, use_checkpoint="scratch",
                               mute=True)
        data = t_dl.preload(poses, images, intr, H, W, cuda)
        t_dl.prepare_device_loop(tr, t_trainer.param_leaves(model.params))
        if not graph:
            def eager(self, body, key, held, steps, before_step=None):
                for j in range(steps):
                    before_step(j)
                    body()
            monkeypatch.setattr(t_dl.StepGraph, "run", eager)
        _cuda.reset_launch_counts()
        losses = []
        for lo in range(0, n, k):
            tr.global_step = lo
            rows = type(draws)(*(None if t is None else t[lo:lo + k] for t in draws))
            losses += list(t_dl.device_train_loop(tr, data, k, draws=rows).losses)
            # what the next dispatch allocates may land where a freed tensor was
            torch.empty((N,), dtype=torch.int64, device=cuda).fill_(7)
        torch.cuda.synchronize()
        runs.append((losses, [p.detach().cpu() for p in t_trainer.param_leaves(model.params)],
                     _cuda.launch_counts(), tr.step_graph))
    (lg, pg, cg, sg), (le, pe, ce, _) = runs
    assert sg.captures == 1
    np.testing.assert_allclose(lg, le, rtol=1e-5)
    for a, b in zip(pg, pe):
        assert rel_l2(a, b) <= 1e-5
    for name in ("K5_compact_pack", "K5_compact_unpack", "K5_compact_unpack_bwd",
                 "K2_march", "K1_hash_encode_bwd"):
        assert cg[name] == ce[name] >= n, name


def test_loop_recaptures_once_when_the_cull_gate_opens(cuda):
    """A clean device loop with --t_cull from a grid one update short of the
    fog gate: the first dispatch captures the exact march (the bool grid),
    the update before its first step opens the gate, the second dispatch
    captures the float grid's march, and every later one replays it: two
    captures in four dispatches, K2's cull route launched once a step
    after the gate and its bool route once a step before."""
    import types

    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from nerf_signature_tpu_torch.train import trainer as t_trainer

    rng = np.random.default_rng(1)
    P, H, W, N, K = 4, 64, 64, 1024, 4
    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    poses[:, 2, 3] = 2.5
    poses[:, :3, :3] = np.diag([1.0, -1.0, -1.0])
    images = rng.uniform(size=(P, H, W, 4)).astype(np.float32)
    intr = np.array([60.0, 60.0, 32.0, 32.0], np.float32)
    model = NGPModel(NGPConfig(bound=1.0, compute_dtype=torch.float32, **WIDTHS["narrow"]),
                     grid_size=32, train_budget=64, seed=2, t_cull=1e-3, device=cuda)
    model.params["hash_table"].data.mul_(1e4)
    for _ in range(15):
        model.update_extra_state(full=True)
    opt = types.SimpleNamespace(lr=1e-2, iters=100, num_rays=N, max_steps=128,
                                compact_frac=0, group_budget=0, update_extra_interval=K)
    tr = t_trainer.Trainer("ngp", opt, model, workspace=None, use_checkpoint="scratch",
                           mute=True)
    data = t_dl.preload(poses, images, intr, H, W, cuda)
    t_dl.prepare_device_loop(tr, t_trainer.param_leaves(model.params))
    _cuda.reset_launch_counts()
    for d in range(4):
        tr.global_step = d * K
        t_dl.device_train_loop(tr, data, K, update_interval=opt.update_extra_interval)
    torch.cuda.synchronize()
    n = _cuda.launch_counts()
    assert tr.step_graph.captures == 2
    assert tr._rc_train().t_cull == 1e-3
    assert n["K2_march"] == K and n["K2_march_cull"] == 3 * K, n


# ------------------------------------------------- K7: the stochastic estimators
K7_GEOMETRIES = [(16, 2, 32), (8, 4, 32), (24, 1, 32), (8, 8, 64), (12, 2, 32), (5, 2, 10)]


def _k7_inputs(cuda, L, F, gather, seed):
    g = torch.Generator().manual_seed(seed)
    res = t_hash.level_resolutions(L, 16, 2048)
    sides = t_hash.level_sides(res, 19, True) if gather == "dense" else None
    rows = int(t_hash.level_row_counts(sides, 19).sum()) if sides else L << 19
    table = (torch.rand((rows, F), generator=g) * 2 - 1).to(cuda)
    x = (torch.rand(((1 << 16) + 77, 3), generator=g) * 1.1 - 0.05).to(cuda)
    gd = torch.float32 if gather == "fp32" else torch.bfloat16
    return g, res, sides, rows, table, x, gd


@pytest.mark.parametrize("gather", ["bf16", "fp32", "dense"])
@pytest.mark.parametrize("L,F,pitch", K7_GEOMETRIES)
def test_k7_fwd_1c_kernel_is_bit_exact(cuda, L, F, pitch, gather):
    """K7's one-corner forward: the chosen row of every (level, sample),
    bit for bit as its plain version chooses it (the same roundings of the
    scaled position, the weights and their running sum), the columns past
    L*F exactly 0."""
    _, res, sides, rows, table, x, gd = _k7_inputs(cuda, L, F, gather, 21)
    tg = table.to(gd)
    k = t_hash._hash_encode_1c_kernel(x, tg, rows, res, 19, False, sides, pitch)
    p = t_hash.hash_encode_1c_plain(x, table, res, 19, dense_sides=sides, table_g=tg)
    assert k.shape == (x.shape[0], pitch) and torch.equal(k[:, :L * F], p)
    assert not bool(k[:, L * F:].any())


def test_k7_fwd_1c_two_geometries_in_turns(cuda):
    """K7's one-corner forward at 16 x 2 and 8 x 4 (dense coarse levels),
    called in turns: each call bit-equal to its plain version, each
    geometry's level arguments built once (``hashenc.level_args``)."""
    cases = []
    for L, F, pitch, gather in ((16, 2, 32, "bf16"), (8, 4, 32, "dense")):
        _, res, sides, rows, table, x, gd = _k7_inputs(cuda, L, F, gather, 30 + L)
        tg = table.to(gd)
        p = t_hash.hash_encode_1c_plain(x, table, res, 19, dense_sides=sides, table_g=tg)
        cases.append((x, tg, rows, list(res), sides, pitch, L * F, p))
    got = set()
    for _ in range(3):
        for x, tg, rows, res, sides, pitch, LF, p in cases:
            k = t_hash._hash_encode_1c_kernel(x, tg, rows, res, 19, False, sides, pitch)
            assert torch.equal(k[:, :LF], p) and not bool(k[:, LF:].any())
            got.add(t_hash.level_args(res, 19, False, sides).ptr)
    assert len(got) == 2


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("gather", ["bf16", "fp32", "dense"])
@pytest.mark.parametrize("L,F,pitch", K7_GEOMETRIES)
def test_k7_bwd_kernel_matches_plain(cuda, L, F, pitch, gather, stride):
    """K7's backward: each kept (level, sample)'s cotangent, unrounded, in
    its chosen row; within 1e-6 relative L2 (the atomics' order), and the
    same rows touched (none chosen differently).  A stride that does not
    divide L runs at 1, as in JAX; through autograd the same."""
    g, res, sides, rows, table, x, gd = _k7_inputs(cuda, L, F, gather, 22 + stride)
    M = x.shape[0]
    g_feat = torch.zeros((M, pitch), device=cuda)
    g_feat[:, :L * F] = torch.randn((M, L * F), generator=g).to(cuda)
    g_feat[::3] = 0.0  # padded samples
    eff = t_hash.effective_stride(L, stride)
    k = t_hash._hash_encode_stoch_bwd_kernel(x, g_feat, rows, res, 19, False, sides, F, eff)
    p = t_hash.hash_encode_stoch_bwd_plain(x, g_feat[:, :L * F].contiguous(), rows, res, 19,
                                           eff, dense_sides=sides)
    assert rel_l2(k, p) <= 1e-6
    assert torch.equal(k.ne(0).any(-1), p.ne(0).any(-1))
    tt = torch.zeros((rows, F), device=cuda, requires_grad=True)
    feat = t_hash.hash_encode(x, tt, res, 19, gather_dtype=gd, table_g=table.to(gd),
                              dense_sides=sides, stochastic_grad=True, level_stride=stride,
                              pitch=pitch)
    feat.backward(g_feat)
    assert rel_l2(tt.grad, p) <= 1e-6


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("L,F,pitch", [(16, 2, 32), (24, 1, 32), (8, 8, 64), (32, 2, 64)])
def test_k7_bwd_kernel_live_lists(cuda, L, F, pitch, stride):
    """K7's backward on the edges of its live lists: M not a multiple of
    its tile (3 tiles and 45 rows), the second tile with no live row, every
    3rd row dead, rows 5::7 live only at their first half of levels, a tile
    of one live row, and the loop's layout (the slots past the kept count
    zero); strides 1, 2 and 4 (each divides every L here).  Within 1e-6
    relative L2 of the plain version (the atomics' order), no row chosen
    differently."""
    g, res, sides, rows, table, x, gd = _k7_inputs(cuda, L, F, "bf16", 40 + L + stride)
    tile = t_hash.stoch_bwd_tile(F, L)
    M = 3 * tile + 45
    x = x[:M].contiguous()
    g3 = torch.randn((M, L, F), generator=g)
    g3[tile:2 * tile] = 0.0
    g3[::3] = 0.0
    g3[5::7, (L + 1) // 2:] = 0.0
    g3[2 * tile:3 * tile] = 0.0
    g3[2 * tile + 7] = torch.randn((L, F), generator=g)
    g3[-20:] = 0.0  # the loop's empty slots at the end
    g_feat = torch.zeros((M, pitch), device=cuda)
    g_feat[:, :L * F] = g3.reshape(M, L * F).to(cuda)
    eff = t_hash.effective_stride(L, stride)
    k = t_hash._hash_encode_stoch_bwd_kernel(x, g_feat, rows, res, 19, False, sides, F, eff)
    p = t_hash.hash_encode_stoch_bwd_plain(x, g_feat[:, :L * F].contiguous(), rows, res, 19,
                                           eff, dense_sides=sides)
    assert rel_l2(k, p) <= 1e-6
    assert torch.equal(k.ne(0).any(-1), p.ne(0).any(-1))


@pytest.mark.parametrize("tile", [0, 48, 288, "over 47 KB"])
def test_k7_bwd_kernel_refuses_a_tile_it_cannot_take(cuda, tile):
    """The tile comes from ``ops/hashenc.py:stoch_bwd_tile``; the C entry
    refuses one that is not a multiple of 32 within the block's 256
    threads, or whose shared memory passes 47 KB (128 samples at 32 levels
    x 8 features), and launches nothing."""
    from nerf_signature_tpu_torch.ops import _cuda

    L, F = (32, 8) if tile == "over 47 KB" else (16, 2)
    tile = 128 if tile == "over 47 KB" else tile
    assert t_hash.stoch_bwd_tile(F, L) == (32 if F == 8 else 128)
    levels = t_hash.level_args(t_hash.level_resolutions(L, 16, 2048), 14)
    x = torch.rand((64, 3), device=cuda)
    g_feat = torch.randn((64, L * F), device=cuda)
    g_table = torch.zeros((L << 14, F), device=cuda)
    before = _cuda.HASH_ENCODE_BWD_STOCH.launches
    with pytest.raises(RuntimeError, match="ngp_hash_encode_bwd_stoch"):
        _cuda.HASH_ENCODE_BWD_STOCH(x.data_ptr(), g_feat.data_ptr(), L * F, F,
                                    g_table.data_ptr(), 64, levels.ptr, 0, 1, tile)
    assert _cuda.HASH_ENCODE_BWD_STOCH.launches == before and not bool(g_table.any())


def test_k7_bwd_kernel_edges(cuda):
    """M = 0, all-zero cotangents (every task skipped), the shared table of
    every level, and the count of launches through autograd: one K1
    forward and one K7 backward (8 corners forward), or one K7 forward."""
    from nerf_signature_tpu_torch.ops import _cuda

    g = torch.Generator().manual_seed(25)
    res = t_hash.level_resolutions(16, 16, 2048)
    out = t_hash._hash_encode_stoch_bwd_kernel(torch.zeros((0, 3), device=cuda),
                                               torch.zeros((0, 32), device=cuda), 1 << 10,
                                               res, 10, False, None, 2, 2)
    assert out.shape == (1 << 10, 2) and not bool(out.any())
    x = torch.rand((50_001, 3), generator=g).to(cuda)
    zero = t_hash._hash_encode_stoch_bwd_kernel(x, torch.zeros((50_001, 32), device=cuda),
                                                16 << 19, res, 19, False, None, 2, 2)
    assert not bool(zero.any())
    gs = torch.randn((50_001, 32), generator=g).to(cuda)
    k = t_hash._hash_encode_stoch_bwd_kernel(x, gs, 1 << 19, res, 19, True, None, 2, 1)
    p = t_hash.hash_encode_stoch_bwd_plain(x, gs, 1 << 19, res, 19, 1, shared_table=True)
    assert rel_l2(k, p) <= 1e-6
    table = torch.zeros((16 << 19, 2), device=cuda, requires_grad=True)
    for corners, fwd in ((8, "K1_hash_encode"), (1, "K7_hash_encode_1c")):
        _cuda.reset_launch_counts()
        t_hash.hash_encode(x, table, res, 19, gather_dtype=torch.bfloat16, stochastic_grad=True,
                           fwd_corners=corners).backward(gs)
        n = _cuda.launch_counts()
        assert n[fwd] == 1 and n["K7_hash_encode_bwd_stoch"] == 1 and n["K1_hash_encode_bwd"] == 0


# ------------------------------------------------ K8: the background sphere
def _bg_inputs(cuda, N, seed, radius=8.0):
    """Rays from inside the sphere (the cameras' orbit, 3.2), and a [4 * 2^15,
    F] table."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((N, 3), generator=g) * 1.5
    d = torch.randn((N, 3), generator=g)
    return g, o.to(cuda), d.to(cuda)


@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("gather", [torch.bfloat16, torch.float32])
def test_k8_kernels_on_positions_match_plain(cuda, gather, F):
    """K8 on given 2D positions: the forward bit for bit (the same corner
    order and roundings), the backward within 1e-5 relative L2 (atomic
    order), each corner's cw * g rounded to bf16 under a bf16 gather as the
    plain version rounds it."""
    g = torch.Generator().manual_seed(30 + F)
    res = t_hash.level_resolutions(4, 16, 2048)
    rows = 4 << 15
    table = (torch.rand((rows, F), generator=g) * 2 - 1).to(cuda)
    x = (torch.rand((40_003, 2), generator=g) * 1.1 - 0.05).to(cuda)
    tg = table.to(gather)
    k = t_hash._hash_encode_2d_kernel(x, None, None, 0.0, tg, res, 15)
    p = t_hash.hash_encode_2d_plain(x, table, res, 15, table_g=tg)
    assert torch.equal(k, p)
    g_feat = torch.randn((40_003, 4 * F), generator=g).to(cuda)
    g_feat[::5] = 0.0
    kb = t_hash._hash_encode_2d_bwd_kernel(x, None, None, 0.0, g_feat, rows, res, 15, gather, F)
    pb = t_hash.hash_encode_2d_bwd_plain(x, g_feat, rows, res, 15, gather)
    assert rel_l2(kb, pb) <= 1e-5


def test_k8_kernels_on_rays_match_plain(cuda):
    """K8 from the rays (the sphere point computed in the kernels) against
    sph_from_ray then the plain encoder: atan2f and the division differ
    from PyTorch's by ulps, and an ulp of the position moves a weight by up
    to res * 6e-8 (1.2e-4 at 2048), so features within 1e-3 absolute and
    the gradient within 1e-3 relative L2; the rays at phi's branch cut
    (within 1e-6) are left out and counted (a ray there may land at either
    end of the map)."""
    from nerf_signature_tpu_torch.ops import _cuda

    g, o, d = _bg_inputs(cuda, 65_537, 40)
    res = t_hash.level_resolutions(4, 16, 2048)
    rows = 4 << 15
    table = (torch.rand((rows, 2), generator=g) * 2 - 1).to(cuda)
    tg = table.to(torch.bfloat16)
    cut = t_hash.sphere_cut(o, d, 8.0)
    k = t_hash._hash_encode_2d_kernel(None, o, d, 8.0, tg, res, 15)
    x = t_hash.sphere_x01(o, d, 8.0)
    p = t_hash.hash_encode_2d_plain(x, table, res, 15, table_g=tg)
    assert float((k - p)[~cut].abs().max()) <= 1e-3
    g_feat = torch.randn((65_537, 8), generator=g).to(cuda)
    g_feat[cut] = 0.0
    kb = t_hash._hash_encode_2d_bwd_kernel(None, o, d, 8.0, g_feat, rows, res, 15,
                                           torch.bfloat16, 2)
    pb = t_hash.hash_encode_2d_bwd_plain(x, g_feat, rows, res, 15, torch.bfloat16)
    assert rel_l2(kb, pb) <= 1e-3
    # through autograd, counted
    _cuda.reset_launch_counts()
    tt = table.clone().requires_grad_(True)
    t_hash.bg_encode(o, d, 8.0, tt, res, 15, gather_dtype=torch.bfloat16).backward(g_feat)
    n = _cuda.launch_counts()
    assert n["K8_hash_encode_2d"] == 1 and n["K8_hash_encode_2d_bwd"] == 1
    assert rel_l2(tt.grad, kb) <= 1e-6


# ------------------------------------- K8: the whole background colour
# limits against the plain chain (ops/background.py): fp32 1e-3 absolute on
# the colour and 1e-3 relative L2 on each gradient (atan2f's ulps at
# resolution 2048, as K8's encoding from the rays; fmaf sums in another
# order than cuBLAS's).  bf16: 4e-3 absolute on the colour (a bf16 step of
# bg_net's output where an fp32 sum rounds the other way, through the
# sigmoid: at most ~2e-3), and on each output a relative L1 limit between
# the kernel's reading and the control's, the fp32 kernel on the
# bf16-rounded table and weights (mlp_apply's activation roundings
# skipped): at these cases the kernel read at most colour 2.3e-5, table
# 5.0e-4, W1 2.2e-3, W2 5.3e-4, the control at least 4.5e-4, 8.9e-3,
# 2.4e-2, 2.4e-3 (scripts_port/bg_limits.py on an H100).
BG_LIM = {torch.float32: 1e-3, torch.bfloat16: 4e-3}
# fp32's backward also gives no cotangent to the rays at bg_net's ReLU kink
# (a layer-1 pre-activation within BG_KINK of 0: background.relu_margin),
# where the sums' orders may set the mask either way (chip_smoke.py BG_KINK)
BG_KINK = 1e-4
BG_RL1_BF16 = {"colour": 1e-4, "bg_table": 2e-3, "W1": 7e-3, "W2": 1.1e-3}


def rel_l1(a, b):
    return float((a.double() - b.double()).abs().sum() / b.double().abs().sum())


def _bg_color_case(cuda, F, dtype, N, seed):
    """(rays_o, rays_d, table, [W1, W2], table_g, packed, meta, cut) of a
    random bg model at 4 levels x 2^15 rows, bg_net 4F + 16 -> 64 -> 3."""
    g, o, d = _bg_inputs(cuda, N, seed)
    table = (torch.rand((4 << 15, F), generator=g) * 2 - 1).to(cuda)
    IN = 4 * F + 16
    w1 = ((torch.rand((IN, 64), generator=g) * 2 - 1) * (6 / IN) ** 0.5).to(cuda)
    w2 = ((torch.rand((64, 3), generator=g) * 2 - 1) * (6 / 64) ** 0.5).to(cuda)
    meta = t_bg.BgMeta(tuple(t_hash.level_resolutions(4, 16, 2048).tolist()), 15, 8.0, dtype, 4)
    tg = table.to(dtype)
    packed = t_bg.pack_bg_net([w1, w2], dtype)
    return o, d, table, [w1, w2], tg, packed, meta, t_hash.sphere_cut(o, d, 8.0)


@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bg_color_kernels_match_chain(cuda, dtype, F):
    """bg_color_fwd against the chain (background_plain) and bg_color_bwd
    + bg_finish against its written-out backward (background_bwd_plain) at
    4096 and a ragged 4133 rays, the rays at phi's cut left out (forward)
    and given no cotangent (backward; in fp32 those at the ReLU kink too,
    fewer than a tenth of them); in bf16 the control, the fp32
    kernels on the bf16-rounded table and weights, is refused by the same
    limits."""
    for N, seed in ((4096, 11), (4133, 50 + F)):
        o, d, table, net, tg, packed, meta, cut = _bg_color_case(cuda, F, dtype, N, seed)
        k = t_bg.bg_color_kernel(o, d, tg, packed, meta)
        p = t_bg.background_plain(o, d, table, net, meta, tg)
        assert k.shape == (N, 3) and float((k - p)[~cut].abs().max()) <= BG_LIM[dtype]
        g = torch.randn((N, 3), generator=torch.Generator().manual_seed(F)).to(cuda) * 1e-2
        g[cut] = 0.0
        if dtype == torch.float32:
            kink = t_bg.relu_margin(o, d, table, net, meta, tg) < BG_KINK
            assert int(kink.sum()) <= N // 10
            g[kink] = 0.0
        gk = t_bg._bg_color_bwd_kernel(o, d, tg, packed, g, table.shape[0], meta)
        gp = t_bg.background_bwd_plain(o, d, table, net, g, meta, tg)
        outs = ("bg_table", "W1", "W2")
        if dtype == torch.float32:
            for a, b in zip(gk, gp):
                assert a.shape == b.shape and rel_l2(a, b) <= BG_LIM[dtype], rel_l2(a, b)
            continue
        meta_c = meta._replace(compute_dtype=torch.float32)
        kc = t_bg.bg_color_kernel(o, d, tg.float(), packed, meta_c)
        gc = t_bg._bg_color_bwd_kernel(o, d, tg.float(), packed, g, table.shape[0], meta_c)
        assert rel_l1(k[~cut], p[~cut]) <= BG_RL1_BF16["colour"] < rel_l1(kc[~cut], p[~cut])
        for name, a, b, c in zip(outs, gk, gp, gc):
            assert a.shape == b.shape
            assert rel_l1(a, b) <= BG_RL1_BF16[name] < rel_l1(c, b), (
                name, rel_l1(a, b), rel_l1(c, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bg_color_bwd_is_bit_equal_over_repeats_and_graph_replays(cuda, dtype):
    """No float atomics: the table's gradient and dW repeat bit for bit,
    eagerly and across two replays of a captured CUDA graph (the kernels
    keep no state between calls)."""
    o, d, table, _, tg, packed, meta, _ = _bg_color_case(cuda, 2, dtype, 4096, 60)
    g = torch.randn((4096, 3), generator=torch.Generator().manual_seed(1)).to(cuda) * 1e-2
    run = lambda: t_bg._bg_color_bwd_kernel(o, d, tg, packed, g, table.shape[0], meta)
    ref = [t.clone() for t in run()]
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(run(), ref))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for _ in range(2):
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_bg_color_through_autograd_launches_one_kernel_each_way(cuda):
    """ngp_background on the card: one forward launch, one backward launch
    (counted; bg_color_bwd + bg_finish) and none of K8's encoding kernels;
    the gradients those of the wrappers; frozen leaves launch no backward."""
    from nerf_signature_tpu_torch.ops import _cuda
    cfg = t_ngp.NGPConfig(bg_radius=8.0)
    params = t_ngp.init_ngp_params(torch.Generator().manual_seed(0), cfg, cuda)
    leaves = [params["bg_table"]] + list(params["bg_net"])
    for p in leaves:
        p.requires_grad_(True)
    _, o, d = _bg_inputs(cuda, 4096, 61)
    g = torch.rand((4096, 3), generator=torch.Generator().manual_seed(2)).to(cuda)
    bp = t_ngp.bg_params(params, cfg)
    _cuda.reset_launch_counts()
    grads = torch.autograd.grad(t_ngp.ngp_background(bp, cfg, o, d), leaves, g)
    n = _cuda.launch_counts()
    assert n["K8_background"] == 1 and n["K8_background_bwd"] == 1
    assert n["K8_hash_encode_2d"] == 0 and n["K8_hash_encode_2d_bwd"] == 0
    want = t_bg._bg_color_bwd_kernel(o, d, bp["bg_table_g"], bp["bg_packed"], g,
                                     params["bg_table"].shape[0], t_ngp.bg_meta(cfg))
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    for p in leaves:
        p.requires_grad_(False)
    _cuda.reset_launch_counts()
    c = t_ngp.ngp_background(t_ngp.bg_params(params, cfg), cfg, o, d)
    assert not c.requires_grad and _cuda.launch_counts()["K8_background"] == 1
    assert _cuda.launch_counts()["K8_background_bwd"] == 0


def test_k7_k8_wrappers_raise_instead_of_falling_back(cuda):
    res = t_hash.level_resolutions(4, 16, 2048)
    tg = torch.zeros((4 << 15, 2), dtype=torch.bfloat16, device=cuda)
    bad = torch.zeros((3, 8), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        t_hash._hash_encode_2d_kernel(None, bad, bad, 8.0, tg, res, 15)
    o, d, table, _, btg, packed, meta, _ = _bg_color_case(cuda, 2, torch.bfloat16, 8, 62)
    with pytest.raises(ValueError, match="contiguous"):
        t_bg.bg_color_kernel(bad, bad, btg, packed, meta)
    with pytest.raises(ValueError, match="shape"):
        t_bg._bg_color_bwd_kernel(o, d, btg, packed, torch.zeros((8, 2), device=cuda),
                                  table.shape[0], meta)
    with pytest.raises(ValueError, match="CUDA"):
        t_bg.bg_color_kernel(o.cpu(), d, btg, packed, meta)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        t_bg.bg_color_kernel(o, d, torch.zeros((4 << 15, 3), device=cuda), packed, meta)
    with pytest.raises(ValueError, match="contiguous"):
        t_hash._hash_encode_1c_kernel(bad, tg, 4 << 15, res, 15, False, None)
    with pytest.raises(ValueError, match="divide"):
        t_hash._hash_encode_stoch_bwd_kernel(torch.zeros((8, 3), device=cuda),
                                             torch.zeros((8, 8), device=cuda), 4 << 15, res, 15,
                                             False, None, 2, 3)


# --------------------------------------------- the CopyRNeRF input (K4 raw, K10)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", ["full", "16x4", "narrow"])
def test_field_kernel_raw_logit(cuda, dtype, widths):
    """K4 with ``want_raw``: sigma, geo and rgb bit-equal to the launch
    without it; the logit within the route's limits of the plain version's
    (fp32 1e-5, bf16 a bf16 step), finite where exp underflows; counted as
    ``K4_field_raw`` / ``_f32``.  Under autograd its cotangent joins
    sigma's (FieldHeadsRawFn): g_feat against the plain autograd within the
    backward's limits (fp32 1e-5, bf16 1e-2 relative L2)."""
    from nerf_signature_tpu_torch.ops import _cuda

    cfg = t_ngp.NGPConfig(compute_dtype=dtype, **WIDTHS[widths])
    params = t_ngp.init_ngp_params(torch.Generator().manual_seed(3), cfg, cuda)
    params["hash_table"].mul_(1e4)
    params["sigma_net"][1][:, 0].mul_(100.0)  # logits far below exp's underflow at -87
    fp = t_ngp.field_params(params, cfg)
    g = torch.Generator().manual_seed(5)
    M = (1 << 16) - 17
    x = (torch.rand((M, 3), generator=g) * 2 - 1).to(cuda)
    d = torch.nn.functional.normalize(torch.randn((M, 3), generator=g), dim=-1).to(cuda)
    feat = t_ngp._encode_pos(fp, cfg, x)
    s0, g0, r0 = t_ngp.field_heads(fp, cfg, feat, d, want_geo=True)
    _cuda.reset_launch_counts()
    s1, g1, r1, raw = t_ngp.field_heads(fp, cfg, feat, d, want_geo=True, want_raw=True)
    counts = _cuda.launch_counts()
    route = "K4_field_raw" if dtype == torch.bfloat16 else "K4_field_raw_f32"
    assert counts[route] == 1 and counts["K4_field"] + counts["K4_field_f32"] == 0
    assert torch.equal(s0, s1) and torch.equal(g0, g1) and torch.equal(r0, r1)
    *_, raw_p = t_ngp.field_heads_plain(fp, cfg, feat[:, :cfg.enc_dim], d, want_raw=True)
    assert bool(torch.isfinite(raw).all()) and bool((raw < -87.0).any())
    if dtype == torch.float32:
        torch.testing.assert_close(raw, raw_p, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(raw, raw_p, rtol=2e-2, atol=1e-2)
    g_sigma = torch.randn(M, generator=g).to(cuda) * 1e-3
    g_rgb = torch.randn((M, 3), generator=g).to(cuda) * 1e-3
    g_raw = torch.randn(M, generator=g).to(cuda) * 1e-3
    grads = []
    for kernel in (True, False):
        f = (feat if kernel else feat[:, :cfg.enc_dim]).clone().requires_grad_(True)
        heads = t_ngp.field_heads if kernel else t_ngp.field_heads_plain
        sigma, _, rgb, lg = heads(fp, cfg, f, d, want_raw=True)
        torch.autograd.backward([sigma, rgb, lg], [g_sigma, g_rgb, g_raw])
        grads.append(f.grad[:, :cfg.enc_dim])
    assert rel_l2(*grads) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("bound", [1.0, 2.0])
@pytest.mark.parametrize("M,D", [(65_519, 32), (1000, 4), (3, 1), (0, 8), (77, 0), (4097, 3),
                                 (70, 1024)])
def test_copyrnerf_input_kernel_matches_plain(cuda, M, D, bound):
    """K10 against its plain version: sincosf against torch.sin/cos of the
    same fp32 products (1e-6 absolute: a few ulps of values in [-1, 1]),
    everything else bit for bit; rows of 88 + D floats staged a block at a
    time (10 at D = 1024), stored in 16-byte pieces where (88 + D) % 4 ==
    0, else 4-byte."""
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import copyrnerf as t_k10

    g = torch.Generator().manual_seed(M + D)
    x = ((torch.rand((M, 3), generator=g) * 2 - 1) * bound).to(cuda)
    d = torch.nn.functional.normalize(torch.randn((M, 3), generator=g), dim=-1).to(cuda)
    rgb = torch.rand((M, 3), generator=g).to(cuda)
    raw = (torch.randn((M,), generator=g) * 50).to(cuda)
    msg = torch.randint(0, 2, (D,), generator=g).to(torch.int32).to(cuda)
    _cuda.reset_launch_counts()
    k = t_k10.copyrnerf_input(x, d, rgb, raw, msg, bound)
    assert _cuda.launch_counts()["K10_copyrnerf_input"] == 1
    p = t_k10.copyrnerf_input_plain(x, d, rgb, raw, msg, bound)
    assert k.shape == p.shape == (M, 88 + D)
    if M:
        assert float((k[:, :84] - p[:, :84]).abs().max()) <= 1e-6
    assert torch.equal(k[:, 84:], p[:, 84:])
    with pytest.raises(ValueError, match="contiguous"):
        t_k10.copyrnerf_input(torch.zeros((3, 8), device=cuda).t(), d[:8], rgb[:8], raw[:8],
                              msg, bound)


# --------------------------------------------- the fixed-step path (cuda_ray off)
@pytest.mark.parametrize("S", [512, 1024])
def test_composite_kernels_at_the_fixed_path_lengths(cuda, S):
    """K3 at the fixed path's lengths (num_steps + upsample_steps slots),
    T_thresh 0 (no early exit) and its dense per-ray hit mask: forward
    within 1e-5, backward within 1e-5 relative L2."""
    N = 4096
    g = torch.Generator().manual_seed(S)
    sig = torch.empty((N, S)).exponential_(1 / 3.0, generator=g)
    rgb = torch.rand((N, S, 3), generator=g)
    dt = torch.rand((N, S), generator=g) * 4.0 / S
    ts = torch.cumsum(dt, -1)
    hit = torch.rand((N,), generator=g) < 0.9
    sig, rgb, dt, ts = (v.to(cuda) for v in (sig, rgb, dt, ts))
    mask = hit.to(cuda)[:, None].expand(N, S).contiguous()
    k = t_comp.composite_rays(sig, rgb, dt, ts, mask=mask, T_thresh=0.0)
    p = t_comp.composite_rays_plain(sig, rgb, dt, ts, mask=mask, T_thresh=0.0)
    for name in k:
        assert float((k[name] - p[name]).abs().max()) <= 1e-5, name
    cts = [torch.randn(shape, generator=g).to(cuda) for shape in ((N,), (N,), (N, 3), (N, S))]
    gs, gr = t_comp.composite_rays_bwd(sig, rgb, dt, ts, mask, 0.0, *cts)
    s_, r_ = sig.clone().requires_grad_(True), rgb.clone().requires_grad_(True)
    out = t_comp.composite_rays_plain(s_, r_, dt, ts, mask=mask, T_thresh=0.0)
    gs_p, gr_p = torch.autograd.grad([out[n] for n in ("weights_sum", "depth", "image",
                                                       "weights")], [s_, r_], cts)
    assert rel_l2(gs, gs_p) <= 1e-5 and rel_l2(gr, gr_p) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fixed_path_chunk_kernels_match_plain(cuda, dtype):
    """A 4096-ray chunk of ``NGPModel(cuda_ray=False)`` at the full widths
    with the pdf upsample (128 + 128 samples): K1, K4 (the SIMT route in
    fp32, the tensor cores in bf16) and K3 launch, and the image is within
    45 dB PSNR of the plain route's (fp32 also within 1e-4)."""
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.ops import _cuda

    cfg = t_ngp.NGPConfig(compute_dtype=dtype)
    m = NGPModel(cfg, cuda_ray=False, num_steps=128, upsample_steps=128, device=cuda)
    m.params["hash_table"].mul_(1e4)
    o, d = _rays(np.random.default_rng(2), 4096, 1.0)
    _cuda.reset_launch_counts()
    k = m.render(o, d)
    counts = _cuda.launch_counts()
    k4 = "K4_field" if dtype == torch.bfloat16 else "K4_field_f32"
    assert counts["K1_hash_encode"] == 2 and counts[k4] == 2 and counts["K3_composite"] == 1
    assert counts["K2_march"] == 0
    p = m.render(o, d, plain=True)
    mse = float(((k["image"] - p["image"]) ** 2).mean())
    assert -10 * np.log10(max(mse, 1e-30)) >= 45.0
    if dtype == torch.float32:
        assert float((k["image"] - p["image"]).abs().max()) <= 1e-4


# ---- K6, the grid update (csrc/grid.cu): the kernel route against the plain
# route on the same draws, bit for bit

def _k6_grid(cuda, dens, live, H):
    from nerf_signature_tpu_torch.ops import grid as t_grid

    C = dens.shape[0]
    return t_grid.OccupancyGrid(torch.from_numpy(dens).to(cuda),
                                torch.zeros((C, H, H, H), dtype=torch.bool, device=cuda),
                                torch.zeros((), device=cuda),
                                torch.tensor(5, dtype=torch.int32, device=cuda),
                                torch.from_numpy(live).to(cuda))


def _k6_draws(cuda, raw):
    from nerf_signature_tpu_torch.ops import grid as t_grid

    return [t_grid.GridDraws(*(None if a is None else torch.from_numpy(a).to(cuda) for a in d))
            for d in raw]


def _k6_bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


K6_CASES = ("empty", "untrained", "one_cell", "edges", "random")


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("name", K6_CASES)
def test_grid_update_points_match_plain(cuda, name, C, full):
    """The queries' cells and positions, kernel against plain, before
    anything downstream (PyTorch's roundings on the card: the divide by H - 1
    as a product with the fp32 reciprocal)."""
    from nerf_signature_tpu_torch.kernel_cases import k6_edge_grids
    from nerf_signature_tpu_torch.ops import grid as t_grid

    H = 32
    (_, dens, live, raw), = [c for c in k6_edge_grids(C, H, full) if c[0] == name]
    grid, draws = _k6_grid(cuda, dens, live, H), _k6_draws(cuda, raw)
    kw = dict(bound=float(C), grid_size=H, full=full)
    k = t_grid.query_points(grid, draws, **kw)
    p = t_grid.query_points(grid, draws, plain=True, **kw)
    for (kc, kx), (pc, px) in zip(k, p):
        assert torch.equal(kc, pc)
        _k6_bits_equal(kx, px)


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("name", K6_CASES)
def test_grid_update_kernel_matches_plain(cuda, name, C, full):
    """update_occupancy_grid_ on the card: its five tensors bit-equal to the
    plain route's, written in place (the same tensors), in several chunks;
    the not-in-place form the same, its input untouched; the launches of
    the update's own kernels."""
    from nerf_signature_tpu_torch.kernel_cases import k6_density, k6_edge_grids
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import grid as t_grid

    H = 32
    (_, dens, live, raw), = [c for c in k6_edge_grids(C, H, full) if c[0] == name]
    draws = _k6_draws(cuda, raw)
    kw = dict(bound=float(C), grid_size=H, full=full, draws=draws, density_thresh=10.0,
              chunk=5000)
    ref = t_grid.update_occupancy_grid_(_k6_grid(cuda, dens, live, H), k6_density, plain=True,
                                        **kw)
    grid = _k6_grid(cuda, dens, live, H)
    before = [(id(t), t.data_ptr()) for t in grid]
    _cuda.reset_launch_counts()
    out = t_grid.update_occupancy_grid_(grid, k6_density, **kw)
    counts = {k: v for k, v in _cuda.launch_counts().items() if v}
    assert out is grid and [(id(t), t.data_ptr()) for t in grid] == before
    for a, b in zip(grid, ref):
        _k6_bits_equal(a, b)
    n = H**3 if full else 2 * (H**3 // 4)
    chunks = -(-n // 5000)
    want = ({"K6_full_points": C, "K6_full_finalize": C * chunks, "K6_full_threshold": 1}
            if full else {"K6_partial_occupied": 1, "K6_partial_points": C,
                          "K6_partial_scatter": C * chunks, "K6_partial_finalize": 1,
                          "K6_partial_threshold": 1})
    assert counts == want
    g0 = _k6_grid(cuda, dens, live, H)
    new = t_grid.update_occupancy_grid(g0, k6_density, **kw)
    for a, b in zip(new, ref):
        _k6_bits_equal(a, b)
    _k6_bits_equal(g0.density, torch.from_numpy(dens).to(cuda))


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_grid_update_of_a_model_matches_plain(cuda, bound):
    """A full-width random model (K1 + K4's queries), grid 128: two full
    updates, then full and partial from the same state, kernel against
    plain through update_extra_state; no host sync in the kernel route."""
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.ops import grid as t_grid

    m = NGPModel(t_ngp.NGPConfig(bound=bound), density_thresh=10.0, grid_size=128, seed=3,
                 device=cuda)
    m.params["hash_table"].mul_(1e4)
    for _ in range(2):
        m.update_extra_state(full=True)
    start = [t.clone() for t in m.occ]
    C = m.occ.density.shape[0]
    for full in (True, False):
        draws = t_grid.draw_grid_randomness(torch.Generator(device=cuda).manual_seed(9), C, 128,
                                            full, cuda)
        outs = []
        for plain in (True, False):
            for a, b in zip(m.occ, start):
                a.copy_(b)
            torch.cuda.synchronize()
            if not plain:
                torch.cuda.set_sync_debug_mode("error")
            try:
                m.update_extra_state(full=full, draws=draws, plain=plain)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            outs.append([t.clone() for t in m.occ])
        for a, b in zip(*outs):
            _k6_bits_equal(a, b)
        assert 0.0 < float(outs[0][1].float().mean()) < 1.0


def test_grid_update_refuses_past_2_to_the_24_cells(cuda):
    from nerf_signature_tpu_torch.kernel_cases import k6_density
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import grid as t_grid

    grid = t_grid.init_occupancy_grid(1.0, 257, device=cuda)
    _cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="2\\^24"):
        t_grid.update_occupancy_grid_(grid, k6_density, bound=1.0, grid_size=257, full=True,
                                      generator=torch.Generator(device=cuda).manual_seed(0))
    assert not any(_cuda.launch_counts().values())
