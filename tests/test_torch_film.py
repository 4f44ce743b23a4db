"""Port parity of the FiLM/SIREN message encoder (``models/film.py``, the
paper's ablated alternative to the codebook; no entry point calls it)
against the JAX package, on JAX's init converted and on the same numpy
features and bits.  Tolerance 1e-5 absolute on outputs of ~0.13: the sine
layers' arguments reach |(15 freq + 30) z| of tens of radians, where an ulp
of the argument (a product summed in another order) moves the sine by
~4e-6; measured <= 6.8e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import film as j_film
from nerf_signature_tpu_torch.models import film as t_film
from nerf_signature_tpu_torch.train.checkpoint import conv_tree_from_jax


@pytest.mark.parametrize("message_dim,feature_dim,n_layers", [(16, 2, 3), (8, 4, 2)])
def test_film_msg_encode_matches_jax(message_dim, feature_dim, n_layers):
    pj = j_film.init_film_msg_encoder(jax.random.PRNGKey(message_dim), message_dim=message_dim,
                                      feature_dim=feature_dim, n_layers=n_layers)
    pt = conv_tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(300, feature_dim)).astype(np.float32)
    for msg in (rng.integers(0, 2, message_dim), np.ones(message_dim, np.int64)):
        oj = np.asarray(j_film.film_msg_encode(pj, jnp.asarray(feat), jnp.asarray(msg)))
        ot = t_film.film_msg_encode(pt, torch.from_numpy(feat), torch.from_numpy(msg)).numpy()
        assert ot.shape == oj.shape == (300, 2)
        np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5)


def test_film_init_matches_jax_layout():
    pj = jax.tree_util.tree_map(np.shape, j_film.init_film_msg_encoder(jax.random.PRNGKey(0)))
    pt = t_film.init_film_msg_encoder(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), pt) == pj
    assert float(pt["layers"][0]["w"].abs().max()) <= 1.0 / 2
    for k in ("b1", "b2"):
        assert not pt["mapping"][k].any()
