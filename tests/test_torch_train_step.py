"""The port's training step against the JAX package's, on the CPU, f32.

* Every assigned config at ``reduced()``: the JAX package draws the
  parameters, the port takes them through ``from_numpy``; the loss and
  every leaf's gradient must agree within 1e-4 relative (‖Δ‖∞/‖ref‖∞ per
  leaf, the LLM forward tests' tolerance: both compute in f32 with other
  summation orders).  Then one AdamW step from those gradients: the
  moments within 1e-4 relative, and the parameters within 2·lr of the
  step plus 1e-5 relative.  The parameter gate is loose on purpose: at
  step 1 AdamW's update is about lr·g/|g| per element, so a gradient
  within cross-framework noise of zero can flip its sign and move the
  parameter by 2·lr; the moments, linear in the gradient, carry the tight
  check.

The backward kernels' plain versions, remat and the loop are in
``test_torch_train_kernels.py`` and ``test_torch_train_loop.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_family as jax_family
from repro.models import make_loss_fn as jax_loss_fn
from repro.train import adamw_init as j_adamw_init
from repro.train import adamw_update as j_adamw_update
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro_torch.configs import ARCHS
from repro_torch.models import make_loss_fn
from repro_torch.models.steps import _value_and_grad
from repro_torch.train import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.tree import paths
from repro_torch.weights import from_numpy

REL = 1e-4          # loss, gradients and moments
PARAM_REL = 1e-5    # the parameters, beside 2·lr
SEQ = 24


def jax_paths(tree):
    """``(key path, numpy leaf)`` in the JAX package's naming."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx",
                                                     getattr(p, "name", p))))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.abs(want).max()
    return float(np.abs(got - want).max() / (den if den else 1.0))


def batch_for(cfg, seed=0, rows=2, seq=SEQ):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        b["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend_tokens:
        b["patches"] = rng.standard_normal(
            (rows, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return b


def reference(name, seed=0):
    """(jax cfg, port cfg, jax params, numpy batch)."""
    jcfg, tcfg = JAX_ARCHS[name].reduced(), ARCHS[name].reduced()
    if jcfg.n_experts:          # no token drops: the routing stays exact
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax_family(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, batch_for(jcfg, seed)


def carry(jparams):
    return from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_grads_and_step_match_the_reference(name):
    jcfg, tcfg, jparams, batch = reference(name)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg)))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tparams = carry(jparams)
    tloss, tgrads = _value_and_grad(make_loss_fn(tcfg))(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) <= REL * abs(float(jloss))
    jg = jax_paths(jgrads)
    tg = dict(paths(tgrads))
    assert sorted(tg) == sorted(jg)
    for key, want in jg.items():
        assert rel(tg[key].numpy(), want) <= REL, (key, rel(tg[key].numpy(),
                                                            want))
    # one AdamW step from each side's own gradients
    jcfg_opt = JAdamWConfig()
    jnew, jstate, jm = jax.jit(j_adamw_update, static_argnums=0)(
        jcfg_opt, jparams, jgrads, j_adamw_init(jparams))
    tnew, tstate, tm = adamw_update(AdamWConfig(), tparams, tgrads,
                                    adamw_init(tparams))
    lr = float(jm["lr"])
    assert rel(float(tm["grad_norm"]), float(jm["grad_norm"])) <= REL
    for field in ("mu", "nu"):
        want = jax_paths(getattr(jstate, field))
        for key, leaf in paths(getattr(tstate, field)):
            assert rel(leaf.numpy(), want[key]) <= REL, (field, key)
    want = jax_paths(jnew)
    for key, leaf in paths(tnew):
        diff = np.abs(leaf.numpy().astype(np.float64) - want[key]).max()
        assert diff <= 2 * lr + PARAM_REL * np.abs(want[key]).max(), key
