"""The port's LLM primitives (``repro_torch.nn.layers``) and configs
against the JAX package's, on the CPU, f32: RoPE, layer norm, SwiGLU,
vocab masking, the attention sublayer with and without a KV cache, and
every route of ``gqa_attention``, the blockwise online-softmax attention
and the blockwise long-cache decode among them (called directly at small
blocks, with causal and window cases, and through ``gqa_attention`` past
its 8192 thresholds).  Within 1e-4 relative (‖Δ‖∞/‖ref‖∞), RoPE tables
within 1e-7 absolute (both cast the same float64 numbers to f32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.nn.layers as jl
import repro_torch.configs as tconfigs
import repro_torch.nn.layers as tl
from test_torch_models_dense import REL, rel

RNG = np.random.default_rng(11)


def draw(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def both(*arrays):
    """Each numpy array as (jax array, torch tensor)."""
    return [(jnp.asarray(a), torch.from_numpy(a.copy())) for a in arrays]


def test_configs_match_jax():
    """Every config, the skips, the pairs and the analytic counts."""
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    for name, cfg in tconfigs.ARCHS.items():
        jcfg = jconfigs.ARCHS[name]
        for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
            assert dataclasses.asdict(c) == dataclasses.asdict(j)
            assert c.padded_vocab == j.padded_vocab
            assert c.param_count() == j.param_count()
            assert c.active_param_count() == j.active_param_count()
    assert tconfigs.SKIPS == jconfigs.SKIPS
    assert tconfigs.pairs() == jconfigs.pairs()
    assert sorted(tconfigs.DIFFUSION_FAMILIES) == sorted(
        jconfigs.DIFFUSION_FAMILIES)
    for name in jconfigs.DIFFUSION_FAMILIES:
        assert tconfigs.get_config(name).name == jconfigs.get_config(name).name
    from repro.models.base import INPUT_SHAPES as JS
    from repro_torch.models.base import INPUT_SHAPES as TS
    assert {k: dataclasses.asdict(v) for k, v in TS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JS.items()}


@pytest.mark.parametrize("head_dim,n,theta", [(64, 40, 10000.0),
                                              (32, 9, 500000.0)])
def test_rope_matches_jax(head_dim, n, theta):
    jc, js = jl.rope_frequencies(head_dim, n, theta)
    tc, ts = tl.rope_frequencies(head_dim, n, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-7, rtol=0)
    (jx, tx), = both(draw(2, 7, 3, head_dim))
    assert rel(tl.apply_rope(tx, tc, ts), jl.apply_rope(jx, jc, js)) <= REL
    pos = np.array([0, 5, n - 1, 3, 2, 1, 0])
    got = tl.apply_rope(tx, tc, ts, torch.from_numpy(pos))
    assert rel(got, jl.apply_rope(jx, jc, js, jnp.asarray(pos))) <= REL


def test_rope_past_the_table_reads_nan_like_jax():
    """A position past the table: ``jnp.take`` fills NaN, so does the port
    (a decode step whose position reaches the cache size)."""
    jc, js = jl.rope_frequencies(16, 4)
    tc, ts = tl.rope_frequencies(16, 4)
    (jx, tx), = both(draw(1, 2, 1, 16))
    pos = np.array([3, 4])
    want = np.asarray(jl.apply_rope(jx, jc, js, jnp.asarray(pos)))
    got = tl.apply_rope(tx, tc, ts, torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, 1]).all() and not np.isnan(got[:, 0]).any()


def test_update_slice_clamps_like_jax():
    dst = np.zeros((2, 6, 3), np.float32)
    src = draw(2, 2, 3)
    for start in (0, 3, 4, 5, 9):
        want = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(dst),
                                                   jnp.asarray(src), start, 1)
        got = tl.update_slice_(torch.from_numpy(dst.copy()),
                               torch.from_numpy(src), start)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_norms_swiglu_and_vocab_mask_match_jax():
    (jx, tx), (jw, tw), (jb, tb) = both(draw(2, 5, 48), draw(48), draw(48))
    assert rel(tl.layer_norm(tx, tw, tb), jl.layer_norm(jx, jw, jb)) <= REL
    jp = jl.init_swiglu(jax.random.PRNGKey(0), 48, 96)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert rel(tl.swiglu(tp, tx), jl.swiglu(jp, jx)) <= REL
    (jlog, tlog), = both(draw(2, 3, 1536))
    got = tl.mask_vocab(tlog, 1500)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jl.mask_vocab(jlog, 1500)))
    assert tl.mask_vocab(tlog, 1536) is tlog


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5), (False, 7)])
def test_blockwise_attention_matches_jax(causal, window):
    """Ragged blocks (30 queries in blocks of 8, 27 keys in blocks of 4),
    with rows whose window holds no key of a block."""
    (jq, tq), (jk, tk), (jv, tv) = both(draw(2, 30, 3, 16), draw(2, 27, 3, 16),
                                        draw(2, 27, 3, 16))
    want = jl._blockwise_attention(jq, jk, jv, causal, window, 0.25,
                                   block_q=8, block_k=4)
    got = tl._blockwise_attention(tq, tk, tv, causal, window, 0.25,
                                  block_q=8, block_k=4)
    assert rel(got, want) <= REL


@pytest.mark.parametrize("window", [None, 6])
def test_blockwise_decode_matches_jax(window):
    """Grouped (4 query heads on 2 KV heads), a cache of 37 slots in blocks
    of 8, of which the first 30 are written; with a window the mask sums
    two large negatives to -inf, as the reference's does."""
    (jq, tq), (jk, tk), (jv, tv) = both(draw(2, 1, 4, 16), draw(2, 37, 2, 16),
                                        draw(2, 37, 2, 16))
    slots = np.arange(37)
    neg = np.finfo(np.float32).min
    mask = np.where(slots <= 29, 0.0, neg).astype(np.float32)
    if window is not None:
        mask = mask + np.where(slots > 29 - window, 0.0, neg).astype(np.float32)
    mask = np.broadcast_to(mask, (2, 1, 1, 37)).copy()
    want = jl._blockwise_decode(jq, jk, jv, jnp.asarray(mask), 0.25, 2,
                                block_k=8)
    got = tl._blockwise_decode(tq, tk, tv, torch.from_numpy(mask), 0.25, 2,
                               block_k=8)
    assert rel(got, want) <= REL


@pytest.mark.parametrize("case", ["dense-causal", "dense-window", "mask",
                                  "long-causal", "long-decode"])
def test_gqa_attention_routes_match_jax(case):
    """Each of ``gqa_attention``'s routes but flash (whose parity has its
    own file): the dense path with causal, window and additive masks,
    the blockwise path past 8192 queries and the blockwise decode past
    8192 cached keys."""
    sq, sk = {"long-causal": (8200, 8200), "long-decode": (1, 8300)}.get(
        case, (40, 40))
    (jq, tq), (jk, tk), (jv, tv) = both(draw(1, sq, 2, 8), draw(1, sk, 1, 8),
                                        draw(1, sk, 1, 8))
    kw = {"dense-causal": dict(causal=True),
          "dense-window": dict(causal=True, window=9),
          "long-causal": dict(causal=True, window=1000)}.get(case, {})
    jkw, tkw = dict(kw), dict(kw)
    if case in ("mask", "long-decode"):
        mask = np.where(np.arange(sk) < sk - 3, 0.0,
                        np.finfo(np.float32).min).astype(np.float32)
        mask = np.broadcast_to(mask, (1, 1, sq, sk)).copy()
        jkw["mask"], tkw["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    want = jl.gqa_attention(jq, jk, jv, **jkw)
    got = tl.gqa_attention(tq, tk, tv, **tkw)
    assert rel(got, want) <= REL


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_block_matches_jax(window, qk_norm):
    """The attention sublayer over a sequence and against a KV cache (5 new
    tokens written at slot 4 of 12, and at slot 10, which clamps to 7)."""
    jp = jl.init_attention(jax.random.PRNGKey(1), 32, 4, 2, qk_norm=qk_norm)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jrope, trope = jl.rope_frequencies(8, 16), tl.rope_frequencies(8, 16)
    (jx, tx), = both(draw(2, 5, 32))
    want, _ = jl.attention_block(jp, jx, 4, 2, rope=jrope, window=window)
    got, none = tl.attention_block(tp, tx, 4, 2, rope=trope, window=window)
    assert none is None and rel(got, want) <= REL
    cache = (draw(2, 12, 2, 8), draw(2, 12, 2, 8))
    pos = np.arange(4, 9)
    for idx in (4, 10):
        want, (jck, jcv) = jl.attention_block(
            jp, jx, 4, 2, rope=jrope, positions=jnp.asarray(pos),
            window=window, kv_cache=tuple(map(jnp.asarray, cache)),
            cache_index=jnp.asarray(idx))
        tcache = tuple(torch.from_numpy(c.copy()) for c in cache)
        got, (tck, tcv) = tl.attention_block(
            tp, tx, 4, 2, rope=trope, positions=torch.from_numpy(pos),
            window=window, kv_cache=tcache, cache_index=idx)
        assert rel(got, want) <= REL
        assert rel(tck, jck) <= REL and rel(tcv, jcv) <= REL
        np.testing.assert_array_equal(tcache[0].numpy(), cache[0])  # a copy


def test_inits_and_batches_have_the_jax_shapes():
    """The port's own draws: ``init_attention`` (with qk-norm) and
    ``init_swiglu`` give the JAX package's keys and shapes, and
    ``synthetic_batch`` and ``frontend_inputs`` its shapes for the VLM and
    the enc-dec families."""
    import repro.models as jm
    import repro_torch.models as tm

    gen = torch.Generator().manual_seed(0)
    for jp, tp in ((jl.init_attention(jax.random.PRNGKey(0), 32, 4, 2,
                                      qk_norm=True),
                    tl.init_attention(gen, 32, 4, 2, qk_norm=True,
                                      device="cpu")),
                   (jl.init_swiglu(jax.random.PRNGKey(0), 32, 48),
                    tl.init_swiglu(gen, 32, 48, device="cpu"))):
        assert {k: tuple(v.shape) for k, v in jp.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}
    for name in ("internvl2-2b", "whisper-tiny"):
        jcfg, tcfg = jconfigs.ARCHS[name].reduced(), tconfigs.ARCHS[name].reduced()
        jb = jm.synthetic_batch(jcfg, jm.TRAIN_4K, batch_override=2,
                                seq_override=8)
        tb = tm.synthetic_batch(tcfg, tm.TRAIN_4K, batch_override=2,
                                seq_override=8, device="cpu")
        assert {k: tuple(v.shape) for k, v in jb.items()} == \
            {k: tuple(v.shape) for k, v in tb.items()}
        assert int(tb["tokens"].max()) < tcfg.vocab
        assert tm.frontend_inputs(tcfg, 3) == jm.frontend_inputs(jcfg, 3)
