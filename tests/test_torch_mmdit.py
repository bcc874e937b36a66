"""The port's MMDiT backbone against ``repro.diffusion.mmdit`` on weights
converted from the JAX package, at the toy size and at a wider small
config (head_dim 64, bf16 weights against f32 activations, as at full
SD3 width).  Tolerance: 1e-5 relative (L2 norm of the difference over
the norm of the JAX output); both compute in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import config as jcfg
from repro.diffusion import mmdit as jm
from repro_torch.diffusion import config as tcfg
from repro_torch.diffusion import mmdit as tm
from repro_torch.weights import from_numpy

WIDE = dict(d_model=128, n_layers=2, n_heads=2, d_ff=256, text_dim=96,
            latent_size=8, latent_channels=16, patch=2, text_tokens=5)
CONFIGS = {
    "toy": (jcfg._TOY, tcfg._TOY),
    "wide-bf16": (jcfg.DiTConfig(**WIDE, dtype=jnp.bfloat16),
                  tcfg.DiTConfig(**WIDE, dtype=torch.bfloat16)),
}


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mmdit_apply_matches_jax(name):
    jc, tc = CONFIGS[name]
    jparams = jm.init_mmdit(jax.random.PRNGKey(3), jc)
    tparams = from_numpy(_numpy_tree(jparams))
    assert tparams["layers"]["img"]["wq"].shape == (jc.n_layers, jc.d_model,
                                                    jc.d_model)
    assert tparams["layers"]["img"]["wq"].dtype == tc.dtype
    r = np.random.default_rng(0)
    lat = r.standard_normal((2, jc.latent_size, jc.latent_size,
                             jc.latent_channels)).astype(np.float32)
    t = np.asarray([0.9, 0.25], np.float32)
    emb = r.standard_normal((2, jc.text_tokens, jc.text_dim)).astype(np.float32)
    want = jm.mmdit_apply(jparams, jc, *map(jnp.asarray, (lat, t, emb)))
    got = tm.mmdit_apply(tparams, tc, *map(torch.from_numpy, (lat, t, emb)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < 1e-5


def test_mmdit_apply_with_control_residuals():
    jc, tc = CONFIGS["toy"]
    jparams = jm.init_mmdit(jax.random.PRNGKey(4), jc)
    tparams = from_numpy(_numpy_tree(jparams))
    r = np.random.default_rng(1)
    lat = r.standard_normal((1, 16, 16, 4)).astype(np.float32)
    t = np.asarray([0.5], np.float32)
    emb = r.standard_normal((1, 8, 64)).astype(np.float32)
    res = r.standard_normal((2, 1, 64, 64)).astype(np.float32) * 0.1
    want = jm.mmdit_apply(jparams, jc, *map(jnp.asarray, (lat, t, emb, res)))
    got = tm.mmdit_apply(tparams, tc, *map(torch.from_numpy, (lat, t, emb, res)))
    assert rel_err(got.numpy(), want) < 1e-5


def test_patchify_roundtrip_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 3)).astype(np.float32)
    got = tm.patchify(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.patchify(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(tm.unpatchify(got, 2, 8, 3).numpy(), x)


def test_full_width_family_geometry():
    """The full-width SD3 family: 4096 image + 333 text tokens, head dim
    64, bf16 weights, about 2.05e9 backbone parameters (counted from a
    one-layer draw: every layer has the same shapes)."""
    fam = dataclasses.replace(tcfg.SD3, toy=tcfg.REAL["sd3"])
    cfg = fam.toy
    assert (cfg.image_tokens, cfg.text_tokens, cfg.head_dim) == (4096, 333, 64)
    one = tm.init_mmdit(torch.Generator().manual_seed(0),
                        dataclasses.replace(cfg, n_layers=1))
    leaves = lambda tree: jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    per_layer = sum(p.numel() for p in leaves(one["layers"]))
    rest = sum(p.numel() for k, p in one.items() if k != "layers")
    assert 2.0e9 < rest + cfg.n_layers * per_layer < 2.1e9
    assert all(p.dtype == torch.bfloat16 for p in leaves(one))
