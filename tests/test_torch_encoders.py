"""The port's text encoder, tokenizer and VAE decoder against
``repro.diffusion.encoders`` on converted weights, at the toy size and at
a wider config (head_dim 64).  Tolerance: 1e-5 relative (L2 norm of the
difference over the norm of the JAX output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import encoders as je
from repro_torch.diffusion import encoders as te
from repro_torch.weights import from_numpy


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_tokenizer_and_hash_match_jax():
    prompts = ["a watercolor fox", "Two FOXES in snow", ""]
    assert te.stable_hash("backbone:sd3") == je.stable_hash("backbone:sd3")
    got = te.tokenize_batch(prompts, 512, 8)
    want = je.tokenize_batch(prompts, 512, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(te.tokenize(prompts[0], 512, 8).numpy(),
                                  np.asarray(je.tokenize(prompts[0], 512, 8)))


@pytest.mark.parametrize("d_model,n_heads", [(64, 4), (256, 4)],
                         ids=["toy-hd16", "wide-hd64"])
def test_text_encoder_matches_jax(d_model, n_heads):
    jp = je.init_text_encoder(jax.random.PRNGKey(0), 512, d_model, n_layers=2,
                              n_heads=n_heads, max_len=8)
    tp = from_numpy(jax.tree.map(np.asarray, jp))
    prompts = ["a watercolor fox", "two foxes in the snow at dusk"]
    want = je.text_encoder_apply(jp, je.tokenize_batch(prompts, 512, 8),
                                 n_heads=n_heads)
    got = te.text_encoder_apply(tp, te.tokenize_batch(prompts, 512, 8),
                                n_heads=n_heads)
    assert tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("channels,size", [(4, 4), (16, 6)])
def test_vae_decode_matches_jax(channels, size):
    jp = je.init_vae(jax.random.PRNGKey(1), latent_channels=channels)
    tp = from_numpy(jax.tree.map(np.asarray, jp))
    lat = np.random.default_rng(0).standard_normal(
        (2, size, size, channels)).astype(np.float32)
    want = je.vae_decode(jp, jnp.asarray(lat))
    got = te.vae_decode(tp, torch.from_numpy(lat))
    assert tuple(got.shape) == want.shape == (2, 8 * size, 8 * size, 3)
    assert got.is_contiguous()
    assert rel_err(got.numpy(), want) < 1e-5


def test_init_trees_match_jax_structure():
    gen = torch.Generator().manual_seed(0)
    tv = te.init_vae(gen, latent_channels=16)
    jv = je.init_vae(jax.random.PRNGKey(0), latent_channels=16)
    shapes = lambda tree: jax.tree.map(lambda x: tuple(x.shape), tree)
    assert shapes(tv) == shapes(jv)
    tt = te.init_text_encoder(gen, 512, 64, 2, 4, max_len=8)
    jt = je.init_text_encoder(jax.random.PRNGKey(0), 512, 64, 2, 4, max_len=8)
    assert shapes(tt) == shapes(jt)
