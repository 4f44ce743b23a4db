"""The hash kernels' launch arguments, built once per table geometry
(``ops/hashenc.py:level_args``), the one-pass tensor checks
(``ops/_cuda.py:check_many``) and K5 unpack's host path, on the CPU.

The cache must hand K1's and K7's C entries what ``_level_args``,
``level_offsets`` and ``combine_mask`` give for the same geometry (exactly:
they are the same numbers), field for field in the level block the C side
reads (``csrc/hashenc.cuh:HashLevels``); two geometries used in turns keep
their own entries; a list, a tuple and a numpy array of the same
resolutions share one; a caller's later change to its list reaches nothing
cached.  The tolerances of the JAX comparison stand beside
``JAX_RESOLUTIONS``.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.ops import hashenc as j_hash
from nerf_signature_tpu_torch.ops import _cuda
from nerf_signature_tpu_torch.ops import compact as t_compact
from nerf_signature_tpu_torch.ops import hashenc as t_hash

S = 19
# name -> (levels, features, shared_table, dense)
GEOMETRIES = {"16x2": (16, 2, False, False), "8x4": (8, 4, False, False),
              "32x2": (32, 2, False, False), "16x2_dense": (16, 2, False, True),
              "16x2_shared": (16, 2, True, False)}


def _geometry(name):
    L, F, shared, dense = GEOMETRIES[name]
    res = t_hash.level_resolutions(L, 16, 2048)
    sides = t_hash.level_sides(res, S, True) if dense else None
    return res, shared, sides


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_cached_level_args_equal_the_per_call_ones(name):
    res, shared, sides = _geometry(name)
    L = len(res)
    a = t_hash.level_args(res, S, shared, sides)
    r, o, s = t_hash._level_args(L, res, S, shared, sides)
    assert np.array_equal(a.res, r) and a.res.dtype == np.float32
    assert np.array_equal(a.offsets, o) and a.offsets.dtype == np.uint32
    assert np.array_equal(a.offsets, t_hash.level_offsets(L, S, shared, sides))
    assert np.array_equal(a.sides, s) and a.sides.dtype == np.uint32
    assert a.combine == t_hash.combine_mask(res)
    # the C level block, field for field, at the address the entries get
    b = a.block
    assert a.ptr == ctypes.addressof(b) and ctypes.sizeof(b) == 8 + 3 * 4 * 32
    assert (b.L, b.log2_size) == (L, S)
    assert list(b.res[:L]) == r.tolist() and list(b.offset[:L]) == o.tolist()
    assert list(b.side[:L]) == s.tolist()
    assert not any(b.res[L:]) and not any(b.offset[L:]) and not any(b.side[L:])


def test_two_geometries_in_turns_keep_their_own_entries():
    ra, _, _ = _geometry("16x2")
    rb, _, _ = _geometry("8x4")
    first = [t_hash.level_args(ra, S), t_hash.level_args(rb, S)]
    for _ in range(3):
        a, b = t_hash.level_args(ra, S), t_hash.level_args(rb, S)
        assert a is first[0] and b is first[1] and a is not b
    assert len(a.res) == 16 and len(b.res) == 8 and a.ptr != b.ptr
    # another log2 size, the shared table or dense sides: entries of their own
    others = {t_hash.level_args(ra, S - 1).ptr, t_hash.level_args(ra, S, True).ptr,
              t_hash.level_args(ra, S, False, t_hash.level_sides(ra, S, True)).ptr}
    assert len(others | {a.ptr}) == 4


def test_a_list_a_tuple_and_an_array_share_one_entry():
    res, _, _ = _geometry("16x2")
    sides = t_hash.level_sides(res, S, True)
    a = t_hash.level_args(res, S, False, sides)
    assert t_hash.level_args(list(res), S, False, list(sides)) is a
    assert t_hash.level_args(tuple(float(r) for r in res), S, False, tuple(sides)) is a


def test_changing_the_callers_list_reaches_nothing_cached():
    res, _, _ = _geometry("8x4")
    mine = [float(r) for r in res]
    a = t_hash.level_args(mine, S)
    mine[0] = 999.0
    assert t_hash.level_args(tuple(res), S) is a
    assert a.res[0] == np.float32(res[0]) and a.block.res[0] == np.float32(res[0])
    b = t_hash.level_args(mine, S)
    assert b is not a and b.res[0] == 999.0 and a.res[0] == np.float32(res[0])


def test_combine_mask_follows_a_sweep_of_its_limit(monkeypatch):
    """The backwards take the cached mask, or the mask at COMBINE_MAX_RES as
    it stands where a sweep moved it after the geometry's first call."""
    res, _, _ = _geometry("16x2")
    a = t_hash.level_args(res, S)
    assert t_hash._combine(a, res) == t_hash.combine_mask(res) == a.combine
    for limit in (0, 128, 1 << 20):
        monkeypatch.setattr(t_hash, "COMBINE_MAX_RES", limit)
        assert t_hash._combine(a, res) == t_hash.combine_mask(res)
    assert t_hash._combine(a, res) == (1 << 16) - 1


# 16 x 2 at resolutions 1, 2, ..., 2^15 (powers of two: ``x * res`` is
# exact, so the two packages' weights agree to the product's ulp) and at the
# recipe's 16, 22, ..., 2048, where XLA on the CPU contracts ``x * res -
# floor(x * res)`` into an FMA: a corner weight moves by up to an ulp of
# ``x * res`` (2^-12 below 2150) and a feature, whose rows lie in [-1, 1],
# by at most twice that over its half-ulp roundings, 2.5e-4 (ROADMAP queue 3)
JAX_RESOLUTIONS = {"pow2": (2.0 ** np.arange(16), 1e-5, 1e-6),
                   "recipe": (j_hash.level_resolutions(16, 16, 2048), 0.0, 2.5e-4)}


@pytest.mark.parametrize("name", list(JAX_RESOLUTIONS))
def test_hash_encode_on_the_cpu_matches_jax_at_16x2(name):
    res, rtol, atol = JAX_RESOLUTIONS[name]
    rng = np.random.default_rng(11)
    table = rng.uniform(-1, 1, size=(16 << 14, 2)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, size=(512, 3)).astype(np.float32)
    fj = j_hash.hash_encode(jnp.asarray(x), jnp.asarray(table), res, 14,
                            gather_dtype="bfloat16")
    ft = t_hash.hash_encode(torch.from_numpy(x), torch.from_numpy(table), res, 14,
                            gather_dtype=torch.bfloat16)
    assert ft.shape == (512, 32) and ft.dtype == torch.float32
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=rtol, atol=atol)


# ------------------------------------------------- the checks, in one pass
def _check_error(t, name, dtype, shape, device=None):
    with pytest.raises((TypeError, ValueError)) as e:
        _cuda.check(t, name, dtype, shape, device)
    return type(e.value), str(e.value)


@pytest.mark.parametrize("fault", ["cpu", "dtype", "shape", "contiguous"])
def test_check_many_raises_what_check_raises(fault):
    """The first spec's fault (here, where no card is, every tensor also
    lies on the CPU) raises the error ``check`` gives that spec, whatever
    the later specs hold; with ``name_device`` that error names its
    device."""
    first = {"cpu": torch.zeros((8, 3)), "dtype": torch.zeros((8, 3), dtype=torch.float64),
             "shape": torch.zeros((8, 2)), "contiguous": torch.zeros((3, 8)).t()}[fault]
    later = (torch.zeros((5, 2), dtype=torch.bfloat16), "table", torch.float32, (4, 2))
    for name_device in (False, True):
        with pytest.raises((TypeError, ValueError)) as e:
            _cuda.check_many((first, "x", torch.float32, (8, 3)), later, name_device=name_device)
        assert (type(e.value), str(e.value)) == _check_error(
            first, "x", torch.float32, (8, 3), first.device if name_device else None)


def test_wrappers_keep_their_errors_on_the_cpu():
    """The hash wrappers check the row width before the tensors, the unpack
    its tensors, with the errors they had."""
    res = t_hash.level_resolutions(2, 16, 64)
    x = torch.rand((64, 3))
    with pytest.raises(ValueError, match="F = 3"):
        t_hash._hash_encode_1c_kernel(x, torch.rand((1 << 10, 3)), 1 << 10, res, 10, False, None)
    with pytest.raises(ValueError, match="x: must be a CUDA tensor"):
        t_hash._hash_encode_1c_kernel(x, torch.rand((1 << 10, 2)), 1 << 10, res, 10, False, None)
    with pytest.raises(ValueError, match="x: must be a CUDA tensor"):
        t_hash._hash_encode_stoch_bwd_kernel(x, torch.rand((64, 4)), 1 << 10, res, 10, False,
                                             None, 2, 1)
    with pytest.raises(TypeError, match="sig_c: expected torch.float32"):
        t_compact._unpack_kernel(torch.zeros(4, dtype=torch.float64), torch.zeros((4, 3)),
                                 torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError, match="sig_c: must be a CUDA tensor on cpu"):
        t_compact._unpack_kernel(torch.zeros(4), torch.zeros((4, 3)), torch.zeros(9))


def test_unpack_views_hold_uncompact_plain_through_autograd(monkeypatch):
    """K5 unpack's outputs are two views of one buffer (rgbs from the first
    16-byte boundary past the sigmas): ``UncompactFn`` returns them and
    their gradients reach sig_c and rgb_c as the plain version's do.  The
    kernel is stood in for by a copy of the plain version's values into the
    wrapper's views (the card runs the kernel: test_torch_kernels.py)."""
    rng = np.random.default_rng(2)
    for N, S_, Mc in ((7, 13, 40), (8, 16, 64)):  # M = 91 (ragged) and 128
        mask = torch.from_numpy(rng.uniform(size=(N, S_)) < 0.4)
        plain = t_compact.compact_plain(mask, torch.rand((N, S_, 3)), torch.rand((N, 3)), Mc)
        slot_of, sample_of = t_compact.slot_maps_plain(plain)
        sig_c = torch.randn(Mc, requires_grad=True)
        rgb_c = torch.rand((Mc, 3), requires_grad=True)
        sp, rp = t_compact.uncompact_plain(sig_c, rgb_c, plain)

        def unpack(sig_c_, rgb_c_, slot_of_, M=N * S_):
            at = -(-M // 4) * 4
            buf = torch.empty((at + 3 * M,))
            sig, rgb = buf.as_strided((M,), (1,)), buf.as_strided((M, 3), (3, 1), at)
            keep = slot_of_ >= 0
            src = slot_of_.clamp_min(0).long()
            sig.copy_(torch.where(keep, sig_c_[src], 0.0))
            rgb.copy_(torch.where(keep[:, None], rgb_c_[src], 0.0))
            return sig, rgb

        def unpack_bwd(g_sig, g_rgb, sample_of_):
            live = sample_of_ >= 0
            i = sample_of_.clamp_min(0).long()
            return (torch.where(live, g_sig[i], 0.0), torch.where(live[:, None], g_rgb[i], 0.0))

        monkeypatch.setattr(t_compact, "_unpack_kernel", unpack)
        monkeypatch.setattr(t_compact, "unpack_bwd", unpack_bwd)
        sk, rk = t_compact.UncompactFn.apply(sig_c, rgb_c, slot_of, sample_of)
        assert sk.is_contiguous() and rk.is_contiguous() and rk.shape == (N * S_, 3)
        assert rk.data_ptr() - sk.data_ptr() == 4 * (-(-N * S_ // 4) * 4)
        assert torch.equal(sk, sp) and torch.equal(rk, rp)
        g = torch.randn(N * S_), torch.randn((N * S_, 3))
        gk = torch.autograd.grad((sk.reshape(N, S_) * 2.0, rk.reshape(N, S_, 3)), (sig_c, rgb_c),
                                 (g[0].reshape(N, S_), g[1].reshape(N, S_, 3)))
        gp = torch.autograd.grad((sp.reshape(N, S_) * 2.0, rp.reshape(N, S_, 3)), (sig_c, rgb_c),
                                 (g[0].reshape(N, S_), g[1].reshape(N, S_, 3)))
        assert all(torch.equal(a, b) for a, b in zip(gk, gp))
