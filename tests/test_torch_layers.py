"""The port's ``nn/layers`` functions against ``repro.nn.layers`` at f32.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerance: atol 1e-5 (both compute in f32; only the order of sums and the
transcendental implementations differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as jl
from repro_torch.nn import layers as tl

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=atol)


def test_rms_norm():
    r = _rng(1)
    x = r.standard_normal((2, 7, 32)).astype(np.float32)
    w = r.standard_normal(32).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_modulate():
    r = _rng(2)
    x, s, g = (r.standard_normal(sh).astype(np.float32)
               for sh in ((3, 5, 16), (3, 16), (3, 16)))
    _close(tl.modulate(*map(torch.from_numpy, (x, s, g))),
           jl.modulate(*map(jnp.asarray, (x, s, g))))


@pytest.mark.parametrize("dim", [256, 15])
def test_timestep_embedding(dim):
    """atol 1e-4: the sin/cos arguments reach 1000 rad, where one f32 ulp
    of the argument (6e-5) already moves the result by that much, and the
    two frameworks' ``exp`` of the frequencies may differ by an ulp."""
    t = _rng(3).uniform(0, 1, 4).astype(np.float32)
    _close(tl.timestep_embedding(torch.from_numpy(t), dim),
           jl.timestep_embedding(jnp.asarray(t), dim), atol=1e-4)


def test_gelu_mlp_and_qdense():
    r = _rng(4)
    p = {"w1": r.standard_normal((16, 64)).astype(np.float32) / 4,
         "b1": r.standard_normal(64).astype(np.float32),
         "w2": r.standard_normal((64, 16)).astype(np.float32) / 8,
         "b2": r.standard_normal(16).astype(np.float32)}
    x = r.standard_normal((2, 5, 16)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _close(tl.gelu_mlp(tp, torch.from_numpy(x)), jl.gelu_mlp(jp, jnp.asarray(x)))
    _close(tl.qdense(torch.from_numpy(x), tp["w1"]),
           jl.qdense(jnp.asarray(x), jp["w1"]))


def test_qdense_promotes_bf16_weights_like_jax():
    """f32 activations against bf16 weights compute in f32, as JAX
    promotes them."""
    r = _rng(5)
    x = r.standard_normal((3, 32)).astype(np.float32)
    w = jnp.asarray(r.standard_normal((32, 8)), jnp.bfloat16)
    tw = torch.from_numpy(np.asarray(w, np.float32)).to(torch.bfloat16)
    out = tl.qdense(torch.from_numpy(x), tw)
    want = jl.qdense(jnp.asarray(x), w)
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    _close(out, want)


@pytest.mark.parametrize("kw", [
    dict(causal=False),
    dict(causal=True),
    dict(causal=True, window=4),
    dict(causal=False, softmax_scale=0.3),
], ids=["full", "causal", "window", "scaled"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_gqa_attention(kw, heads):
    hq, hkv = heads
    r = _rng(6)
    q = r.standard_normal((2, 12, hq, 16)).astype(np.float32)
    k = r.standard_normal((2, 12, hkv, 16)).astype(np.float32)
    v = r.standard_normal((2, 12, hkv, 16)).astype(np.float32)
    _close(tl.gqa_attention(*map(torch.from_numpy, (q, k, v)), **kw),
           jl.gqa_attention(*map(jnp.asarray, (q, k, v)), **kw))


def test_gqa_attention_additive_mask():
    r = _rng(7)
    q, k, v = (r.standard_normal((1, 6, 2, 8)).astype(np.float32)
               for _ in range(3))
    m = np.where(r.uniform(size=(1, 1, 6, 6)) < 0.3, -1e9, 0.0).astype(np.float32)
    _close(tl.gqa_attention(*map(torch.from_numpy, (q, k, v)),
                            mask=torch.from_numpy(m)),
           jl.gqa_attention(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(m)))


def test_init_shapes_match_jax():
    import jax

    gen = torch.Generator().manual_seed(0)
    tm = tl.init_mlp(gen, 16, 64)
    jm = jl.init_mlp(jax.random.PRNGKey(0), 16, 64)
    assert {k: tuple(v.shape) for k, v in tm.items()} == \
        {k: tuple(v.shape) for k, v in jm.items()}
    assert tl.dense_init(gen, 8, 4, torch.bfloat16).shape == (8, 4)
    assert tl.dense_init(gen, 8, 4, torch.bfloat16).dtype == torch.bfloat16
    assert tl.embed_init(gen, 10, 6).shape == (10, 6)
    # scale applied in f32 before the cast, like dense_init in JAX
    w = tl.dense_init(torch.Generator().manual_seed(1), 4096, 64)
    assert abs(float(w.std()) - 1 / 64) < 1e-3
