"""The port's recurrent families against the JAX package's, on the CPU:
recurrentgemma-2b (RG-LRU blocks and local attention) and xlstm-1.3b
(mLSTM and sLSTM), f32, within 1e-4 relative
(``test_torch_models_dense.check_family``).

``reduced()`` keeps 2 layers, which for the hybrid are 2 RG-LRU blocks and
no local attention, and for the xLSTM 2 remainder mLSTM blocks and no
sLSTM.  So the hybrid also runs at 4 layers (one (r, r, a) super-block and
a remainder block) and the xLSTM at 9 (one 7:1 super-block and a
remainder block).  On the CPU the hybrid's scan takes the RG-LRU plain
version, which launches no kernel.

The hybrid also decodes from the default (bf16) decode cache: the JAX
package's step hands the conv tails back in f32 (``concatenate`` of the
bf16 tail and the f32 input), so after the first step the port's must be
f32 too, holding the unrounded values, or the logits drift (2.4e-3 to
3.9e-3 from the second step on).  Every family's returned cache keeps
the reference's dtypes, key by key, after a step from its default
cache: no tolerance."""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import get_family as jax_family
from repro.models import make_serve_step as jax_serve
from repro_torch.configs import ARCHS
from repro_torch.kernels.rglru_scan.kernel import rglru_scan
from repro_torch.models import get_family, make_serve_step
from test_torch_models_dense import (cache_dtypes, carry, check_decode,
                                     check_family, check_forward, configs,
                                     inputs)


@pytest.mark.parametrize("name,layers", [("recurrentgemma-2b", 2),
                                         ("recurrentgemma-2b", 4),
                                         ("xlstm-1.3b", 2),
                                         ("xlstm-1.3b", 9)])
def test_recurrent_family_matches_jax(name, layers):
    before = rglru_scan.launches
    check_family(name, n_layers=layers)
    assert rglru_scan.launches == before


@pytest.mark.parametrize("layers", [2, 4])
def test_hybrid_decode_from_the_default_bf16_cache(layers):
    """recurrentgemma-2b, 16 steps from bf16 caches: logits within 1e-4
    relative at every step, the cache's dtypes the reference's."""
    jcfg, tcfg = configs("recurrentgemma-2b", n_layers=layers)
    jparams, tparams = check_forward("recurrentgemma-2b", jcfg, tcfg)
    check_decode("recurrentgemma-2b", jcfg, tcfg, jparams, tparams,
                 dtype="bfloat16")


def test_hybrid_decode_hands_back_new_tails():
    """The promoted tails are new tensors in the returned dict: the
    caller's bf16 tails keep their dtype and their zeros; from the second
    step on the f32 tails are written in place."""
    _, tcfg = configs("recurrentgemma-2b", n_layers=4)
    fam = get_family(tcfg)
    params = fam.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    cache = fam.init_decode_cache(tcfg, 2, 8, device="cpu")
    step = make_serve_step(tcfg)
    _, first = step(params, cache, torch.tensor([1, 2]))
    for key in ("tail", "tail_rem"):
        assert cache[key].dtype == torch.bfloat16
        assert not cache[key].any()
        assert first[key].dtype == torch.float32 and first[key].any()
    _, second = step(params, first, torch.tensor([3, 4]))
    for key in ("tail", "tail_rem"):
        assert second[key] is first[key]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_decode_cache_dtypes_match_the_reference(name):
    """One decode step from each family's default cache: every returned
    key in the reference's dtype (the hybrid's tails promoted to f32, its
    ring caches kept bf16)."""
    changes = {"hybrid": {"n_layers": 4}, "ssm": {"n_layers": 9}}.get(
        ARCHS[name].arch_type, {})
    jcfg, tcfg = configs(name, **changes)
    jfam, tfam = jax_family(jcfg), get_family(tcfg)
    jparams = jfam.init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tparams = carry(jparams)
    batch, enc_out = inputs(jcfg)
    jcache = jfam.init_decode_cache(jcfg, 2, 5)
    tcache = tfam.init_decode_cache(tcfg, 2, 5, device="cpu")
    if enc_out is not None:     # the encoder's output, as a prefill leaves it
        jcache["enc_out"] = jnp.asarray(enc_out)
        tcache["enc_out"] = torch.from_numpy(enc_out.copy())
    tok = batch["tokens"][:, 0]
    _, jcache = jax_serve(jcfg)(jparams, jcache, jnp.asarray(tok))
    _, tcache = make_serve_step(tcfg)(tparams, tcache,
                                      torch.from_numpy(tok).long())
    assert cache_dtypes(tcache) == cache_dtypes(jcache)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 1
