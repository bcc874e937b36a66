"""The port's RG-LRU scan against the JAX package's, on the CPU.

Tolerance: 2e-5 absolute and relative (the JAX package's kernel grid,
``tests/test_kernels.py``): both compute in float32, the associative scan
in a log-depth order and the kernel step by step, so their roundings
differ.  The literal recurrence is held at 1e-5, as in the JAX package.

Long memory: with ``a`` uniform in [0.99, 0.9999] (RecurrentGemma's
published initialisation keeps ``a`` this close to 1) a state carries over
hundreds to thousands of steps, where the normal draws above forget it
within a few dozen.  There the plain version is held against the JAX
oracle at 2e-5 and against a float64 literal recurrence at 5e-5 absolute
and relative: float32 roundings add up over the memory length, about
7e-6 of the f64 value at T 4097 (a numpy run of both read 7.1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ops import rglru as jax_rglru
from repro.kernels.rglru_scan.ref import rglru_ref as jax_rglru_ref
from repro_torch.kernels.rglru_scan.kernel import rglru_scan
from repro_torch.kernels.rglru_scan.ops import rglru
from repro_torch.kernels.rglru_scan.ref import rglru_ref

KEY = jax.random.PRNGKey(42)
GRID = [(2, 128, 128), (1, 200, 96), (3, 64, 256), (2, 300, 50)]


def _inputs(b, t, d):
    ks = jax.random.split(KEY, 2)
    a = jax.nn.sigmoid(jax.random.normal(ks[0], (b, t, d)))
    x = jax.random.normal(ks[1], (b, t, d))
    return a, x


@pytest.mark.parametrize("b,t,d", GRID)
def test_rglru_matches_jax(b, t, d):
    a, x = _inputs(b, t, d)
    ta, tx = (torch.from_numpy(np.array(v)) for v in (a, x))
    before = rglru_scan.launches
    got = rglru(ta, tx)
    assert rglru_scan.launches == before      # CPU tensors: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, t, d)
    torch.testing.assert_close(got, rglru_ref(ta, tx), rtol=0, atol=0)
    for want in (jax_rglru_ref(a, x),
                 jax_rglru(a, x, block_t=64, block_d=64, use_kernel=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("t", [1, 2, 9, 33])
def test_rglru_ref_is_the_literal_recurrence(t):
    """Odd and even lengths walk both branches of the odd/even recursion."""
    a = jax.nn.sigmoid(jax.random.normal(KEY, (1, t, 3)))
    x = jax.random.normal(KEY, (1, t, 3))
    an, xn = np.array(a), np.array(x)
    ref = rglru_ref(torch.from_numpy(an), torch.from_numpy(xn)).numpy()
    h = np.zeros((1, 3))
    for s in range(t):
        h = an[:, s] * h + np.sqrt(1 - an[:, s] ** 2) * xn[:, s]
        np.testing.assert_allclose(ref[:, s], h, atol=1e-5)


def test_rglru_ref_keeps_the_input_dtype():
    """bf16 in, bf16 out, computed in float32 (as the JAX oracle)."""
    a, x = _inputs(1, 16, 8)
    ta = torch.from_numpy(np.array(a)).to(torch.bfloat16)
    tx = torch.from_numpy(np.array(x)).to(torch.bfloat16)
    got = rglru_ref(ta, tx)
    want = jax_rglru_ref(jnp.asarray(a, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2)


def _long_memory(b, t, d, seed=0):
    """float32 numpy inputs with ``a`` uniform in [0.99, 0.9999]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.99, 0.9999, (b, t, d)).astype(np.float32)
    return a, rng.standard_normal((b, t, d)).astype(np.float32)


def literal_f64(a, x):
    """The recurrence step by step in float64 from float32 inputs."""
    a, x = a.astype(np.float64), x.astype(np.float64)
    g = np.sqrt(np.maximum(1.0 - a * a, 0.0)) * x
    out, h = np.empty_like(a), np.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + g[:, t]
        out[:, t] = h
    return out


@pytest.mark.parametrize("b,t,d", [(2, 1000, 64), (1, 4097, 48)])
def test_rglru_long_memory(b, t, d):
    a, x = _long_memory(b, t, d)
    got = rglru(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_rglru_ref(a, x)),
                               atol=2e-5, rtol=2e-5)
    want = literal_f64(a, x)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)
    # the memory is real: 300 steps on, every state still holds the first
    # input (a ** 300 is about 0.2 here, where sigmoid draws give 1e-90)
    x0 = x.copy()
    x0[:, 0] += 1.0
    moved = rglru(torch.from_numpy(a), torch.from_numpy(x0)).numpy()
    assert np.abs(moved[:, 300] - got[:, 300]).min() > 1e-3
