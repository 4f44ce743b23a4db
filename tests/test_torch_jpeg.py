"""Port parity of the differentiable JPEG (``utils/jpeg.py``) against the JAX
package on the same inputs: the tables, the block DCT before rounding, the
whole ``jpeg_dct`` layer and its straight-through gradient, the real-codec
``diff_jpeg_ste`` and ``random_diff_jpeg`` at the same quality index.

Tolerances and why:
  * the block DCT before rounding: 1e-5 relative, with an absolute floor of
    1e-5 of the 255-level range (coefficients reach ~1e3, so an fp32 ulp is
    up to 6e-5; the colour transform and the two 8x8 products round in
    another order than XLA's fused einsum: 3e-5 at most, measured);
  * the whole layer: ``round(coef / q)`` turns a last-ulp difference of a
    coefficient sitting at .5 into a whole quantisation step, so the
    elementwise check is atol 1e-5 on every pixel of a block whose rounded
    levels agree, and the share of pixels off by more than 1e-5 is held to
    at most 1% (a flip moves the 64 pixels of its 8x8 block);
  * the straight-through gradient: atol 1e-5 (the same linear map);
  * the real codec: exactly equal (the same PIL calls on the same bytes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.utils import jpeg as j_jpeg
from nerf_signature_tpu_torch.utils import jpeg as t_jpeg

T = torch.from_numpy
SHAPES = [(2, 16, 24), (1, 13, 10)]  # multiples of 8, and not


def _images(shape, seed=0):
    rng = np.random.default_rng(seed)
    B, H, W = shape
    # a smooth field plus texture, like a rendered block
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    base = 0.5 + 0.3 * np.sin(6 * yy[..., None] + 4 * xx[..., None] + rng.uniform(0, 6, 3))
    return np.clip(base[None] + 0.1 * rng.normal(size=(B, H, W, 3)), 0, 1).astype(np.float32)


def _jax_coef(img):
    x, _, _ = j_jpeg._pad_to8(jnp.clip(jnp.asarray(img), 0.0, 1.0))
    B, Hp, Wp, _ = x.shape
    ycc = j_jpeg._rgb_to_ycbcr(x) * 255.0 - 128.0
    blocks = jnp.transpose(ycc.reshape(B, Hp // 8, 8, Wp // 8, 8, 3), (0, 1, 3, 5, 2, 4))
    D = jnp.asarray(j_jpeg._DCT)
    return np.asarray(jnp.einsum("ij,...jk,lk->...il", D, blocks, D))


def test_tables_match_jax():
    assert np.array_equal(t_jpeg._DCT, j_jpeg._DCT)
    assert np.array_equal(t_jpeg._Q_LUMA, j_jpeg._Q_LUMA)
    assert np.array_equal(t_jpeg._Q_CHROMA, j_jpeg._Q_CHROMA)
    for q in (1.0, 10.0, 49.0, 50.0, 80.0, 100.0):
        qj = jnp.clip(jnp.floor(jnp.stack([j_jpeg._Q_LUMA, j_jpeg._Q_CHROMA, j_jpeg._Q_CHROMA])
                                * j_jpeg._quality_scale(jnp.float32(q)) + 0.5), 1.0, 255.0)
        assert np.array_equal(t_jpeg.quant_table(q, "cpu").numpy(), np.asarray(qj)), q


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("quality", [10, 50, 80, 100])
def test_jpeg_dct_matches_jax(shape, quality):
    img = _images(shape, seed=quality)
    cj = _jax_coef(img)
    ct, (H, W) = t_jpeg.dct_coefficients(T(img))
    assert (H, W) == shape[1:]
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-5, atol=1e-5 * 255)

    yj = np.asarray(j_jpeg.jpeg_dct(jnp.asarray(img), float(quality)))
    yt = t_jpeg.jpeg_dct(T(img), float(quality)).numpy()
    assert yt.shape == img.shape
    # the rounded levels: where they agree in a block, its pixels agree
    q = t_jpeg.quant_table(float(quality), "cpu").numpy()
    flips = np.round(ct.numpy() / q) != np.round(cj / q)        # [B, Hb, Wb, 3, 8, 8]
    blk_same = ~flips.any(axis=(3, 4, 5))                        # [B, Hb, Wb]
    pix_same = np.repeat(np.repeat(blk_same, 8, 1), 8, 2)[:, :shape[1], :shape[2]]
    np.testing.assert_allclose(yt[pix_same], yj[pix_same], rtol=0, atol=1e-5)
    assert np.mean(np.abs(yt - yj) > 1e-5) <= 0.01
    assert flips.sum() <= 2


def test_jpeg_dct_quality_as_a_tensor():
    img = _images((1, 16, 16))
    a = t_jpeg.jpeg_dct(T(img), 60.0)
    b = t_jpeg.jpeg_dct(T(img), torch.tensor(60.0))
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_jpeg_dct_straight_through_gradient_matches_jax(shape):
    img = _images(shape, seed=3)
    ct = np.random.default_rng(4).normal(size=img.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x: j_jpeg.jpeg_dct(x, 50.0), jnp.asarray(img))
    (gj,) = vjp(jnp.asarray(ct))
    x = T(img).requires_grad_(True)
    t_jpeg.jpeg_dct(x, 50.0).backward(T(ct))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), rtol=0, atol=1e-5)


def test_diff_jpeg_ste_matches_jax():
    pytest.importorskip("PIL")
    img = _images((2, 16, 24), seed=5)
    ct = np.random.default_rng(6).normal(size=img.shape).astype(np.float32)
    yj, vjp = jax.vjp(lambda x: j_jpeg.diff_jpeg_ste(x, 60), jnp.asarray(img))
    (gj,) = vjp(jnp.asarray(ct))
    x = T(img).requires_grad_(True)
    yt = t_jpeg.diff_jpeg_ste(x, 60)
    yt.backward(T(ct))
    assert np.array_equal(yt.detach().numpy(), np.asarray(yj))
    assert np.array_equal(x.grad.numpy(), np.asarray(gj)) and np.array_equal(x.grad.numpy(), ct)


@pytest.mark.parametrize("use_dct", [True, False])
def test_random_diff_jpeg_at_the_same_quality_index(use_dct):
    if not use_dct:
        pytest.importorskip("PIL")
    img = _images((1, 16, 16), seed=7)
    key = jax.random.PRNGKey(3)
    yj = np.asarray(j_jpeg.random_diff_jpeg(key, jnp.asarray(img), low=40, use_dct=use_dct))
    index = int(jax.random.randint(key, (), 0, 6))
    yt = t_jpeg.random_diff_jpeg(T(img), torch.tensor(index), low=40, use_dct=use_dct).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5)
    # the port's own draw is an index into the same six qualities
    assert t_jpeg.jpeg_qualities(40).tolist() == [40.0, 50.0, 60.0, 70.0, 80.0, 90.0]
    idx = t_jpeg.jpeg_quality_index(torch.Generator().manual_seed(0), "cpu")
    assert idx.dim() == 0 and 0 <= int(idx) < 6
