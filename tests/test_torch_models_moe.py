"""The port's MoE and VLM families against the JAX package's, on the CPU:
granite-moe-1b-a400m (top 2 of 4 experts at ``reduced()``), grok-1-314b
and internvl2-2b (256 -> 8 patch embeddings ahead of the text), f32,
within 1e-4 relative (``test_torch_models_dense.check_family``).

The MoE forward runs at the default capacity factor, so over 64 tokens an
expert can overflow its 40 slots and drop pairs: both packages must drop
the same ones.  The chosen experts are compared exactly, so that a
routing flip shows as a flip and not as a tolerance miss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_family as jax_family
from repro.models.transformer import moe_apply as jax_moe_apply
from repro_torch.models import transformer as tfm
from test_torch_models_dense import REL, carry, check_family, configs, rel


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "grok-1-314b",
                                  "internvl2-2b"])
def test_moe_and_vlm_families_match_jax(name):
    check_family(name)


def jax_experts(p, x, cfg):
    """The JAX package's routing decision, from public JAX calls."""
    probs = jax.nn.softmax((x @ p["router"]).astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.experts_per_token)[1])


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "grok-1-314b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_chooses_the_same_experts(name, capacity_factor):
    """Every layer's router picks the same experts for the same tokens, and
    ``moe_apply`` (dispatch, experts, combine) agrees, with and without
    capacity drops; a router of zeros (every expert tied) picks the lowest
    indices in both."""
    jcfg, tcfg = configs(name, capacity_factor=capacity_factor)
    jparams = jax_family(jcfg).init(jax.random.PRNGKey(3), jcfg)
    tparams = carry(jparams)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((96, jcfg.d_model)) * 3).astype(np.float32)
    for i in range(jcfg.n_layers):
        jp = jax.tree.map(lambda a: a[i], jparams["blocks"])
        tp = tfm.layer(tparams["blocks"], i)
        _, top_e = tfm.route(tp, torch.from_numpy(x), tcfg)
        np.testing.assert_array_equal(top_e.numpy(), jax_experts(jp, x, jcfg))
        want = jax_moe_apply(jp, jnp.asarray(x), jcfg)
        got = tfm.moe_apply(tp, torch.from_numpy(x), tcfg)
        assert rel(got, want) <= REL, (name, i, rel(got, want))
    tied = {**tp, "router": torch.zeros_like(tp["router"])}
    _, top_e = tfm.route(tied, torch.from_numpy(x), tcfg)
    jtied = {**jp, "router": jnp.zeros_like(jp["router"])}
    np.testing.assert_array_equal(top_e.numpy(), jax_experts(jtied, x, jcfg))
    assert (top_e.numpy() == np.arange(tcfg.experts_per_token)).all()


def test_moe_drops_overflow_like_jax():
    """A router that sends every token to expert 0 first overflows its
    capacity: the dropped pairs contribute nothing in both packages."""
    jcfg, tcfg = configs("granite-moe-1b-a400m")
    jparams = jax_family(jcfg).init(jax.random.PRNGKey(4), jcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    bias = np.zeros((jcfg.d_model, jcfg.n_experts), np.float32)
    bias[:, 0] = 0.5
    jp = {**jp, "router": jp["router"] + bias}
    tp = carry(jp)
    x = np.abs(np.random.default_rng(6).standard_normal(
        (64, jcfg.d_model))).astype(np.float32)
    _, top_e = tfm.route(tp, torch.from_numpy(x), tcfg)
    cap = max(8, min(int(tcfg.capacity_factor * 64 * 2 / 4), 64))
    assert int((top_e == 0).sum()) > cap          # expert 0 overflows
    want = jax_moe_apply(jp, jnp.asarray(x), jcfg)
    got = tfm.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert rel(got, want) <= REL
