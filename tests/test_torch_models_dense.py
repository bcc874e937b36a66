"""The port's LLM serving path against the JAX package's, on the CPU: the
dense GQA families (llama3-8b, yi-34b, qwen3-1.7b with qk-norm,
h2o-danube-3-4b with native SWA) at ``reduced()``, f32.

Each family: the JAX package draws the parameters, the port takes them
through ``repro_torch.weights.from_numpy``; the forward logits over 32
tokens, ``make_prefill_step``'s last logits, and 16 ``make_serve_step``
calls from a 17-deep full cache (and, where ``swa_decode_variant`` is set,
from a ring cache of 8 slots, which wraps) must agree within 1e-4
relative (‖Δ‖∞/‖ref‖∞): both compute in f32 with other summation orders.

The other families' files import :func:`check_family` from here."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_family as jax_family
from repro.models import make_prefill_step as jax_prefill
from repro.models import make_serve_step as jax_serve
from repro_torch.configs import ARCHS
from repro_torch.models import get_family, make_prefill_step, make_serve_step
from repro_torch.weights import from_numpy

REL = 1e-4
SEQ = 32           # forward and prefill length
STEPS = 16         # decode steps
RING_WINDOW = 8    # ring slots: the ring wraps twice in STEPS steps


def rel(got, want, vocab=None) -> float:
    """‖got - want‖∞ / ‖want‖∞, over the first ``vocab`` columns of logits
    (the padded ones hold -1e9, which would swamp the ratio)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    return float(np.abs(got - want).max() / np.abs(want).max())


def configs(name, **changes):
    """The JAX package's and the port's reduced config, with ``changes``."""
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), **changes)
    tcfg = dataclasses.replace(ARCHS[name].reduced(), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def carry(jparams):
    """The JAX parameter tree as the port's (CPU, f32)."""
    return from_numpy(jax.tree.map(np.asarray, jparams))


def inputs(cfg, seed=0, seq=SEQ):
    """Numpy tokens, frontend inputs and decode tokens from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend_tokens:
        batch["patches"] = rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    enc_out = (rng.standard_normal((2, cfg.encoder_seq, cfg.d_model))
               .astype(np.float32) if cfg.is_encoder_decoder else None)
    return batch, enc_out


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def check_forward(name, jcfg, tcfg, seed=0):
    """Forward and prefill parity; returns the carried parameters."""
    jfam, tfam = jax_family(jcfg), get_family(tcfg)
    jparams = jfam.init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tparams = carry(jparams)
    batch, _ = inputs(jcfg, seed)
    tbatch = to_torch(batch)
    kw = {k: batch[k] for k in ("frames", "patches") if k in batch}
    want = jfam.forward(jparams, jcfg, batch["tokens"], remat=False, **kw)
    got = tfam.forward(tparams, tcfg, tbatch["tokens"],
                       **{k: tbatch[k] for k in kw})
    v = jcfg.vocab
    assert tuple(got.shape) == want.shape == (2, SEQ, jcfg.padded_vocab)
    assert rel(got, want, v) <= REL, (name, "forward", rel(got, want, v))
    want = jax_prefill(jcfg)(jparams, batch)
    got = make_prefill_step(tcfg)(tparams, tbatch)
    assert tuple(got.shape) == want.shape == (2, jcfg.padded_vocab)
    assert rel(got, want, v) <= REL, (name, "prefill", rel(got, want, v))
    return jparams, tparams


def cache_dtypes(cache) -> dict:
    """Each cache key's dtype by name; ``pos`` is left out (the port keeps
    it a Python int, the JAX package an int32 scalar)."""
    return {k: str(v.dtype).replace("torch.", "") for k, v in cache.items()
            if k != "pos"}


def check_decode(name, jcfg, tcfg, jparams, tparams, ring=False, seed=0,
                 dtype="float32"):
    """``STEPS`` serve steps from a fresh cache of ``dtype`` (the two
    packages' ``init_decode_cache`` argument), logits at every step and,
    after each step, every cache key in the reference's dtype."""
    jfam, tfam = jax_family(jcfg), get_family(tcfg)
    batch, enc_out = inputs(jcfg, seed)
    kw = dict(ring=True, window=RING_WINDOW) if ring else {}
    jcache = jfam.init_decode_cache(jcfg, 2, STEPS + 1,
                                    dtype=getattr(jnp, dtype), **kw)
    tcache = tfam.init_decode_cache(tcfg, 2, STEPS + 1,
                                    dtype=getattr(torch, dtype), device="cpu",
                                    **kw)
    if enc_out is not None:     # the encoder's output, as a prefill leaves it
        jcache["enc_out"] = jnp.asarray(enc_out)
        tcache["enc_out"] = torch.from_numpy(enc_out.copy())
    jstep = jax.jit(jax_serve(jcfg, ring=ring))
    tstep = make_serve_step(tcfg, ring=ring)
    for t in range(STEPS):
        tok = batch["tokens"][:, t]
        want, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        got, tcache = tstep(tparams, tcache, torch.from_numpy(tok).long())
        assert rel(got, want, jcfg.vocab) <= REL, (
            name, "ring" if ring else "full", dtype, t,
            rel(got, want, jcfg.vocab))
        assert cache_dtypes(tcache) == cache_dtypes(jcache), (name, dtype, t)
    assert int(tcache["pos"]) == int(jcache["pos"]) == STEPS


def check_family(name, **changes):
    jcfg, tcfg = configs(name, **changes)
    jparams, tparams = check_forward(name, jcfg, tcfg)
    check_decode(name, jcfg, tcfg, jparams, tparams)
    if tcfg.swa_decode_variant:
        check_decode(name, jcfg, tcfg, jparams, tparams, ring=True)


@pytest.mark.parametrize("name", ["llama3-8b", "yi-34b", "qwen3-1.7b",
                                  "h2o-danube-3-4b"])
def test_dense_family_matches_jax(name):
    check_family(name)


def test_port_init_has_the_jax_tree():
    """The port's own init draws the JAX package's tree: the same keys and
    leaf shapes, for every family (reduced; the hybrid and xLSTM deep
    enough to hold super-blocks and remainders)."""
    for name in sorted(ARCHS):
        changes = {"hybrid": {"n_layers": 4}, "ssm": {"n_layers": 9}}.get(
            ARCHS[name].arch_type, {})
        jcfg, tcfg = configs(name, **changes)
        jtree = jax_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
        ttree = get_family(tcfg).init(torch.Generator().manual_seed(0), tcfg,
                                      device="cpu")
        jshapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                   jax.tree_util.tree_flatten_with_path(jtree)[0]}
        tshapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                   jax.tree_util.tree_flatten_with_path(
                       ttree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
        assert jshapes == tshapes, name
