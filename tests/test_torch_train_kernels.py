"""The training path's kernel routes, rematerialisation and step options
on the CPU, against the JAX package.

* The backward kernels' plain versions against the JAX package's VJPs:
  ``attention_bwd_ref`` against ``jax.vjp`` of ``repro``'s ``mha`` (its
  ``_flash_bwd``; the Pallas forward in interpret mode) over the JAX
  package's flash grid (causal, windowed, Sq != Sk, D 8-64) plus rows that
  see no key, and ``rglru_bwd_ref`` against ``jax.vjp(rglru_ref)``,
  long-memory gates included: 1e-5 relative (f32 products summed in
  another order), but 1e-4 for ``da`` under long-memory gates, whose
  slope term ``-a / sqrt(1 - a^2)`` magnifies the rounding of ``1 - a^2``
  by up to ``1 / (1 - a^2)``, 5e3 at a = 0.9999 (compiled, XLA rounds that
  expression otherwise: 2.5e-5 measured at (1, 300, 8)).
* The ``autograd.Function``s on CPU tensors: the forward and its
  log-sum-exp are the plain versions, the gradients those of autograd
  through the plain versions (1e-5), and no kernel launch is counted.
* ``remat=True`` and ``remat=False`` give the same loss and gradients bit
  for bit (recomputation repeats the same operations).
* ``make_train_step`` with ``accum_steps=2`` and with
  ``optimizer="adafactor"`` against the JAX package's: the loss within
  1e-4 relative, the moments (AdamW) or factored statistics (Adafactor)
  within 1e-4 relative, the parameters within 2·lr of the step plus 1e-5
  relative (the sign-flip argument of ``test_torch_train_step.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha as jax_mha
from repro.kernels.rglru_scan.ref import rglru_ref as jax_rglru_ref
from repro.models import make_train_step as jax_train_step
from repro.train import adafactor_init as j_adafactor_init
from repro.train import adamw_init as j_adamw_init
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)
from repro_torch.kernels.rglru_scan import kernel as rk
from repro_torch.kernels.rglru_scan.ops import rglru
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref
from repro_torch.models import get_family, make_train_step
from repro_torch.models.steps import cross_entropy
from repro_torch.train import adafactor_init, adamw_init
from repro_torch.train.tree import leaves, paths, unflatten
from test_torch_train_step import batch_for, carry, jax_paths, reference, rel

BWD_REL = 1e-5
REL = 1e-4
PARAM_REL = 1e-5

FLASH_GRID = [     # tests/test_kernels.py's grid, and rows that see no key
    ((2, 128, 128, 64), False, None),
    ((2, 256, 256, 32), True, None),
    ((1, 200, 200, 16), True, 64),
    ((1, 64, 256, 64), False, None),
    ((2, 100, 300, 8), False, 128),
    ((1, 120, 90, 16), True, 7),
]


@pytest.mark.parametrize("shape,causal,window", FLASH_GRID)
def test_attention_bwd_ref_matches_the_reference_vjp(shape, causal, window):
    bh, sq, sk, d = shape
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.standard_normal((bh, n, d)).astype(np.float32)
                   for n in (sq, sk, sk, sq))

    def attend(q, k, v):        # [BH, S, D] through mha's [B, S, H, D]
        return jax_mha(q[:, :, None], k[:, :, None], v[:, :, None],
                       causal=causal, window=window)[:, :, 0]

    _, vjp = jax.vjp(attend, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    o, lse = fk.flash_attention(tq, tk, tv, causal=causal, window=window,
                                return_lse=True)
    got = attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                            window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        # absolute where the reference is all zeros (a row's only key)
        err = np.abs(g.numpy() - w).max()
        assert err <= BWD_REL * max(np.abs(w).max(), 1.0), (name, err)


@jax.jit
def _jax_rglru_vjp(a, x, dh):
    h, vjp = jax.vjp(jax_rglru_ref, a, x)
    return (h, *vjp(dh))


@pytest.mark.parametrize("shape,long_memory", [((2, 37, 5), False),
                                               ((3, 128, 16), False),
                                               ((1, 300, 8), True),
                                               ((2, 1, 4), True)])
def test_rglru_bwd_ref_matches_the_reference_vjp(shape, long_memory):
    rng = np.random.default_rng(2)
    if long_memory:        # RecurrentGemma's published range of a
        a = 0.99 + 0.0099 * rng.random(shape)
    else:
        a = 1 / (1 + np.exp(-rng.standard_normal(shape)))
    a = a.astype(np.float32)
    x, dh = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    h, *want = _jax_rglru_vjp(*(jnp.asarray(t) for t in (a, x, dh)))
    ta, tx, tdh = (torch.from_numpy(t) for t in (a, x, dh))
    th = rglru_ref(ta, tx)
    assert rel(th.numpy(), np.asarray(h)) <= BWD_REL
    got = rglru_bwd_ref(ta, tx, th, tdh)
    for name, g, w in zip(("da", "dx"), got, want):
        tol = 1e-4 if long_memory and name == "da" else BWD_REL
        assert rel(g.numpy(), np.asarray(w)) <= tol, name


def _autograd(fn, inputs, grad_out):
    xs = [t.clone().requires_grad_() for t in inputs]
    out = fn(*xs)
    return out.detach(), torch.autograd.grad(out, xs, grad_out)


@pytest.mark.parametrize("causal,window", [(False, None), (True, 5)])
def test_flash_function_on_the_cpu_takes_the_plain_versions(causal, window):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 19, 3, 16), generator=gen) for _ in range(3))
    k, v = k[:, :, :1], v[:, :, :1]                      # GQA, 3 to 1
    do = torch.randn((2, 19, 3, 16), generator=gen)
    launches = (fk.flash_attention.launches, fk.flash_attention_bwd.launches)
    out, got = _autograd(lambda q, k, v: mha(q, k, v, causal=causal,
                                             window=window), (q, k, v), do)

    def plain(q, k, v):
        kt = k.repeat_interleave(3, dim=2).permute(0, 2, 1, 3).reshape(6, 19, 16)
        vt = v.repeat_interleave(3, dim=2).permute(0, 2, 1, 3).reshape(6, 19, 16)
        qt = q.permute(0, 2, 1, 3).reshape(6, 19, 16)
        o = attention_ref(qt, kt, vt, causal=causal, window=window)
        return o.reshape(2, 3, 19, 16).permute(0, 2, 1, 3)

    want_out, want = _autograd(plain, (q, k, v), do)
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        assert rel(g.numpy(), w.numpy()) <= BWD_REL
    assert (fk.flash_attention.launches,
            fk.flash_attention_bwd.launches) == launches
    lse = attention_lse_ref(q.permute(0, 2, 1, 3).reshape(6, 19, 16),
                            k.repeat_interleave(3, 2).permute(0, 2, 1, 3)
                            .reshape(6, 19, 16), causal=causal, window=window)
    assert torch.isfinite(lse).all()


def test_rglru_function_on_the_cpu_takes_the_plain_versions():
    gen = torch.Generator().manual_seed(4)
    a = torch.sigmoid(torch.randn((2, 50, 8), generator=gen))
    x, dh = (torch.randn((2, 50, 8), generator=gen) for _ in range(2))
    launches = (rk.rglru_scan.launches, rk.rglru_scan_bwd.launches)
    out, got = _autograd(rglru, (a, x), dh)
    want_out, want = _autograd(rglru_ref, (a, x), dh)
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        assert rel(g.numpy(), w.numpy()) <= BWD_REL
    assert (rk.rglru_scan.launches, rk.rglru_scan_bwd.launches) == launches


@pytest.mark.parametrize("name", ["whisper-tiny", "recurrentgemma-2b",
                                  "xlstm-1.3b", "llama3-8b"])
def test_remat_gives_the_same_gradients_bit_for_bit(name):
    _, cfg, _, batch = reference(name)
    if name == "recurrentgemma-2b":       # a super-block and a remainder
        cfg = dataclasses.replace(cfg, n_layers=5)
    if name == "xlstm-1.3b":              # a 7:1 super-block and a remainder
        cfg = dataclasses.replace(cfg, n_layers=9)
    fam = get_family(cfg)
    params = fam.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    kw = {k: tb[k] for k in ("frames", "patches") if k in tb}
    results = []
    for remat in (True, False):
        xs = [p.detach().requires_grad_() for p in leaves(params)]
        loss = cross_entropy(fam.forward(unflatten(params, xs), cfg,
                                         tb["tokens"], remat=remat, **kw),
                             tb["labels"])
        results.append((loss.detach(), torch.autograd.grad(loss, xs)))
    (l1, g1), (l2, g2) = results
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("name,optimizer,accum", [
    ("whisper-tiny", "adamw", 2),
    ("recurrentgemma-2b", "adamw", 2),
    ("llama3-8b", "adafactor", 1),
    ("recurrentgemma-2b", "adafactor", 2),
])
def test_train_step_options_match_the_reference(name, optimizer, accum):
    jcfg, cfg, jparams, batch = reference(name)
    batch = batch_for(jcfg, 5, rows=4)
    j_init = j_adamw_init if optimizer == "adamw" else j_adafactor_init
    init = adamw_init if optimizer == "adamw" else adafactor_init
    jstep = jax.jit(jax_train_step(jcfg, accum_steps=accum,
                                   optimizer=optimizer))
    jnew, jstate, jm = jstep(jparams, j_init(jparams),
                             jax.tree.map(jnp.asarray, batch))
    tparams = carry(jparams)
    tnew, tstate, tm = make_train_step(cfg, accum_steps=accum,
                                       optimizer=optimizer)(
        tparams, init(tparams),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert rel(float(tm["loss"]), float(jm["loss"])) <= REL
    lr = float(jm["lr"])
    assert rel(float(tm["lr"]), lr) <= 1e-7
    fields = ("mu", "nu") if optimizer == "adamw" else ("vr", "vc")
    for field in fields:
        want = jax_paths(getattr(jstate, field))
        for key, leaf in paths(getattr(tstate, field)):
            assert rel(leaf.numpy(), want[key]) <= REL, (field, key)
    want = jax_paths(jnew)
    for key, leaf in paths(tnew):
        diff = np.abs(leaf.numpy().astype(np.float64) - want[key]).max()
        assert diff <= 2 * lr + PARAM_REL * np.abs(want[key]).max(), key
