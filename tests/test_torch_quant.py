"""Quantized forwards (``REPRO_QUANT=int8|fp8``) in the port against the JAX
package, on the CPU, at the toy size.

Tolerances, and why:

* quantization, the int8 product and the int8 projection: **bit for bit**.
  ``quantize_weight``, ``_quantize_rows`` and ``quant_matmul_ref`` give the
  JAX package's bits (``torch.round`` and ``jnp.round`` both round half to
  even, and the int32 accumulation is exact); the int8 ``quant_apply``
  equals the JAX package's jitted one with and without its kernel;
* the fp8 projection: 1e-6 relative (a float32 product whose sums run in
  another order);
* one toy ``mmdit_apply``: fp8 1e-5; int8 5e-3, with the control "port
  int8 against the JAX package's fp32" at 5e-3 or more.  int8 is not
  continuous in its input: the port's float32 activations differ from the
  JAX package's by about 4e-7 relative, and wherever that flips an int8
  rounding the forward moves by far more.  On this input the JAX package
  itself moves by up to 5.3e-3 when its latents are nudged by 1e-7
  relative (``test_int8_forward_moves_with_tiny_nudges``), so no int8 bound
  below that is meaningful; 5e-3 still fails a port that left the
  projections in float32 (1.16e-2);
The served path and LoRA on a quantized base are in
``tests/test_torch_quant_serving.py``.

Every comparison is against the JAX package in the same mode, never
against its fp32 output, apart from the controls."""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.diffusion as jdiff
from repro.core.executor import AdapterPool as JAdapterPool
from repro.diffusion import encoders as je
from repro.diffusion import mmdit as jm
from repro.kernels.quant_matmul import ops as jq
from repro.kernels.quant_matmul.ref import quant_matmul_ref as jq_ref
from repro.nn import layers as jlayers
import repro_torch.diffusion as tdiff
from repro_torch.core.executor import AdapterPool
from repro_torch.core.profiles import ProfileStore
from repro_torch.core.transport import decode_value, encode_value
from repro_torch.diffusion import encoders as te
from repro_torch.diffusion import lora as tl
from repro_torch.diffusion import mmdit as tm
from repro_torch.diffusion.ops import (
    DiffusionBackbone,
    LoRAAdapter,
    TextEncoder,
    VAEDecode,
)
from repro_torch.kernels.quant_matmul import ops as tq
from repro_torch.kernels.quant_matmul.kernel import (
    BLOCK_K,
    BLOCK_N,
    ROUTE_ROWS,
    plan,
    quant_matmul,
    quantize_rows,
)
from repro_torch.kernels.quant_matmul.ref import (
    quant_matmul_ref,
    quantize_rows_ref,
)
from repro_torch.nn import layers as tlayers
from repro_torch.weights import from_numpy

KEY = jax.random.PRNGKey(11)
GRID = [(1, 8, 8), (5, 24, 40), (33, 128, 96), (128, 100, 200)]
FWD_TOL = {"int8": 5e-3, "fp8": 1e-5}


@contextlib.contextmanager
def quant(mode):
    """The same mode in both packages (each reads it at load and fold)."""
    prev = (jlayers.set_quant_mode(mode), tlayers.set_quant_mode(mode))
    try:
        yield
    finally:
        jlayers.set_quant_mode(prev[0])
        tlayers.set_quant_mode(prev[1])


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def bits(t):
    """The raw bytes of a torch or JAX array, for bit-for-bit checks."""
    a = t.contiguous().view(torch.uint8).numpy() if isinstance(
        t, torch.Tensor) else np.ascontiguousarray(np.asarray(t)).view(np.uint8)
    return a.reshape(-1)


def same_bits(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree, a quantized dict counting as a leaf."""
    if isinstance(tree, dict) and not tq.is_quantized(tree):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


# --------------------------------------------------------------------------
# (a) quantization: bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape,dtype", [((64, 48), np.float32),
                                         ((64, 48), "bfloat16"),
                                         ((2, 64, 48), np.float32),
                                         ((3, 96, 40), "bfloat16")])
def test_quantize_weight_matches_jax(mode, shape, dtype):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32) / 8
    jw = jnp.asarray(w).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = jq.quantize_weight(jw, mode)
    got = tq.quantize_weight(from_numpy(np.asarray(jw)), mode)
    assert tq.is_quantized(got)
    assert got["qw"].dtype == (torch.int8 if mode == "int8"
                               else torch.float8_e4m3fn)
    assert got["qs"].dtype == torch.float32
    assert tuple(got["qs"].shape) == shape[:-2] + (1, shape[-1])
    same_bits(got["qw"], want["qw"])
    same_bits(got["qs"], want["qs"])
    same_bits(tq.dequantize_weight(got), jq.dequantize_weight(want))
    # quantizing twice is the identity (quantize-on-fold re-entrancy)
    assert tq.quantize_weight(got, mode) is got


def _rows_probe(m, k, seed):
    """``[m, k]`` float32 activations with the rows that pin the bits: an
    all-zero row (scale 1); rows whose row maximum is 127 * 2**e, so the
    scale is exactly 2**e and every quotient lands on a .5 (round half to
    even decides it); a row whose small negative entries round to -0.0;
    the rest normal draws of both signs."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32) * 3
    x[0] = 0.0
    for row, e in ((1, 0), (2, -3), (3, 4)):
        if row < m:
            halves = r.integers(-127, 127, k).astype(np.float32) + 0.5
            x[row] = halves * np.float32(2.0 ** e)
            x[row, r.integers(0, k)] = np.float32(127.0 * 2.0 ** e)
    if m > 4:
        x[4] = -0.3
        x[4, 0] = 127.0
    return x


def test_quantize_rows_matches_jax():
    """The JAX package quantizes activations inside its jitted
    ``_quant_apply``, where XLA computes the row scale ``amax / 127`` as a
    product with the float32 reciprocal: compared with that jitted form,
    at K from 17 to 16384.  The plain version, the wrapper and
    ``ops._quantize_rows`` on CPU tensors all give its bits, and the
    wrapper counts no launch."""
    for m, k in ((333, 1536), (128, 100), (4, 9216), (7, 17), (16, 6144),
                 (5, 16384)):
        x = _rows_probe(m, k, seed=m * 7 + k)
        want_q, want_s = jax.jit(jq._quantize_rows)(jnp.asarray(x))
        before = quantize_rows.launches
        for fn in (quantize_rows_ref, quantize_rows, tq._quantize_rows):
            got_q, got_s = fn(torch.from_numpy(x))
            assert got_q.dtype == torch.int8 and got_q.shape == (m, k)
            assert got_s.dtype == torch.float32 and got_s.shape == (m, 1)
            same_bits(got_q, want_q)
            same_bits(got_s, want_s)
        assert quantize_rows.launches == before
        assert float(got_s[0]) == 1.0
        if m > 3:   # the scales 2**e are exact, so every quotient is a .5
            assert got_s[1:4, 0].tolist() == [1.0, 2.0 ** -3, 2.0 ** 4]
            ties = torch.from_numpy(x[1:4]) / got_s[1:4]
            assert int((ties.abs() % 1 == 0.5).sum()) == 3 * (k - 1)
        if m > 4:   # -0.3 rounds to -0.0, stored as 0
            assert bool((got_q[4, 1:] == 0).all())


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_roundtrip_and_shrink(mode):
    """The port of ``tests/test_quant.py``'s representation test."""
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, 48)).astype(np.float32)) / 8.0
    q = tq.quantize_weight(w, mode)
    back = tq.dequantize_weight(q)
    assert rel_err(back.numpy(), w.numpy()) <= (1e-2 if mode == "int8" else 4e-2)
    qbytes = sum(t.numel() * t.element_size() for t in q.values())
    assert qbytes < 0.3 * w.numel() * 4


# --------------------------------------------------------------------------
# (b) the int8 product's plain version: bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", GRID)
def test_quant_matmul_ref_matches_jax(m, k, n):
    r = np.random.default_rng(m * k + n)
    xq = r.integers(-127, 128, (m, k)).astype(np.int8)
    wq = r.integers(-127, 128, (k, n)).astype(np.int8)
    xs = r.random((m, 1)).astype(np.float32) / 50
    ws = r.random((1, n)).astype(np.float32) / 50
    want = jq_ref(*map(jnp.asarray, (xq, wq, xs, ws)))
    got = quant_matmul_ref(*map(torch.from_numpy, (xq, wq, xs, ws)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    same_bits(got, want)
    # the wrapper takes the plain version for CPU tensors and counts nothing
    before = quant_matmul.launches
    same_bits(quant_matmul(*map(torch.from_numpy, (xq, wq, xs, ws))), want)
    assert quant_matmul.launches == before


@pytest.mark.parametrize("m,k,n,route,splits", [
    # the full-width int8 path on an H100's 132 SMs: image stream, text
    # stream, text encoder (one and two prompts), the per-layer ada product
    (16384, 1536, 1536, 0, 1), (16384, 1536, 6144, 0, 1),
    (16384, 6144, 1536, 0, 1), (1332, 1536, 6144, 0, 1),
    (1332, 1536, 1536, 1, 1), (1332, 6144, 1536, 1, 1),
    (333, 4096, 4096, 1, 1), (333, 4096, 16384, 0, 1),
    (333, 16384, 4096, 1, 2), (666, 4096, 4096, 1, 1),
    (4, 1536, 9216, 2, 4),
    # the split is capped by the partial sums' bytes, and by a short K
    (64, 4096, 1536, 2, 4), (100, 1536, 1536, 1, 1), (3, 1000, 72, 2, 4),
    (1, 8, 8, 2, 1)])
def test_quant_matmul_plan(m, k, n, route, splits):
    """The CUDA product's tiles and split: 128-row tiles where they give two
    blocks an SM, 16-row tiles streaming wq for M <= 64, 64-row tiles
    between; a grid under two blocks an SM splits K, every split non-empty,
    while the int32 partial sums stay within half the operands' bytes."""
    assert plan(m, k, n, 132) == (route, splits)
    blocks = -(-m // ROUTE_ROWS[route]) * -(-n // BLOCK_N)
    k_split = -(-(-(-k // BLOCK_K)) // splits) * BLOCK_K
    assert (splits - 1) * k_split < k <= splits * k_split
    if splits > 1:
        assert blocks < 2 * 132
        assert 8 * splits * m * n <= (m * k + k * n) / 2


@pytest.mark.parametrize("k", [256, 16384])
def test_quant_matmul_ref_is_int32_accumulating(k):
    """All-127 operands: 127 * 127 * K in every element, exact (an int8 or
    float32 accumulator would not be)."""
    m, n = 4, 8
    xq = np.full((m, k), 127, np.int8)
    wq = np.full((k, n), 127, np.int8)
    xs = np.ones((m, 1), np.float32)
    ws = np.ones((1, n), np.float32)
    got = quant_matmul_ref(*map(torch.from_numpy, (xq, wq, xs, ws)))
    want = np.full((m, n), 127.0 * 127.0 * k, np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    same_bits(got, jq_ref(*map(jnp.asarray, (xq, wq, xs, ws))))


# --------------------------------------------------------------------------
# (c) the quantized projection
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", GRID)
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_apply_matches_jax(m, k, n, mode):
    r = np.random.default_rng(7 * m + k)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = (r.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w), mode)
    tw = from_numpy(_numpy_tree(jw))
    got = tq.quant_apply(torch.from_numpy(x), tw["qw"], tw["qs"])
    for use_kernel in (False, True):
        want = jq.quant_apply(jnp.asarray(x), jw["qw"], jw["qs"],
                              use_kernel=use_kernel, block_m=32, block_n=32,
                              block_k=32)
        if mode == "int8":
            same_bits(got, want)
        else:
            assert rel_err(got.numpy(), want) <= 1e-6


def test_quant_apply_takes_leading_dims_and_layer_slices():
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((2, 5, 24)).astype(np.float32))
    q = tq.quantize_weight(torch.from_numpy(
        r.standard_normal((3, 24, 16)).astype(np.float32)), "int8")
    got = tq.quant_apply(x, q["qw"][1:2], q["qs"][1:2])
    want = tq.quant_apply(x.reshape(10, 24), q["qw"][1], q["qs"][1])
    assert tuple(got.shape) == (2, 5, 16)
    same_bits(got.reshape(10, 16), want)
    # qdense routes by structure: a quantized dict takes the quantized route
    same_bits(tlayers.qdense(x, {"qw": q["qw"][1], "qs": q["qs"][1]}), got)


# --------------------------------------------------------------------------
# (d) quantizing the model trees
# --------------------------------------------------------------------------

def _compare_quantized_trees(got, want, keys):
    got_leaves = dict(_leaves(got))
    want_leaves = dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    quantized = set()
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert tq.is_quantized(g) == jq.is_quantized(w), path
        if tq.is_quantized(g):
            quantized.add(path[-1])
            same_bits(g["qw"], w["qw"])
            same_bits(g["qs"], w["qs"])
        else:
            same_bits(g, w)
    assert quantized == set(keys)


def _tree_bytes(tree):
    return sum(sum(t.numel() * t.element_size() for t in v.values())
               if tq.is_quantized(v) else v.numel() * v.element_size()
               for _, v in _leaves(tree))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_mmdit_params_matches_jax(mode):
    cfg = jdiff.FAMILIES["sd3"].toy
    params = jm.init_mmdit(KEY, cfg)
    tparams = from_numpy(_numpy_tree(params))
    with quant(mode):
        want = jm.quantize_mmdit_params(params)
        got = tm.quantize_mmdit_params(tparams)
    _compare_quantized_trees(got, want, tm._QUANT_STREAM_KEYS)
    assert not tq.is_quantized(got["patch_embed"])
    assert _tree_bytes(got) < 0.6 * _tree_bytes(tparams)   # test_quant.py:149
    with quant("off"):                              # the identity when off
        same = tm.quantize_mmdit_params(tparams)
    assert all(a is b for (_, a), (_, b) in zip(_leaves(same),
                                                 _leaves(tparams)))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_text_params_matches_jax(mode):
    params = je.init_text_encoder(KEY, 512, 64, n_layers=2, n_heads=4,
                                  max_len=8)
    tparams = from_numpy(_numpy_tree(params))
    with quant(mode):
        want = je.quantize_text_params(params)
        got = te.quantize_text_params(tparams)
    _compare_quantized_trees(got, want, ("wq", "wk", "wv", "wo", "w1", "w2"))
    assert _tree_bytes(got) < 0.6 * _tree_bytes(tparams)


def test_from_numpy_carries_quantized_leaves_exactly():
    """int8 and fp8 leaves come across bit for bit, and a quantized dict's
    leaves keep their types whatever ``dtype`` asks."""
    w = jnp.asarray(np.random.default_rng(4).standard_normal((2, 16, 8)),
                    jnp.bfloat16)
    for mode, qdtype in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        q = jq.quantize_weight(w, mode)
        tree = from_numpy({"q": _numpy_tree(q), "w": np.asarray(w)},
                          dtype=torch.float32)
        assert tree["q"]["qw"].dtype == qdtype
        assert tree["q"]["qs"].dtype == torch.float32
        assert tree["w"].dtype == torch.float32          # a plain leaf is cast
        same_bits(tree["q"]["qw"], q["qw"])
        same_bits(tree["q"]["qs"], q["qs"])
        tree16 = from_numpy(_numpy_tree(q), dtype=torch.bfloat16)
        assert tree16["qs"].dtype == torch.float32


def test_port_quantizes_its_own_draw_and_caller_weights():
    """Under int8 a load quantizes the stream and text projections of the
    model's own draw and of plain weights a caller hands in alike."""
    fam = tdiff.FAMILIES["sd3"]
    with quant("int8"):
        own = DiffusionBackbone(fam).load("cpu")["params"]
        enc = TextEncoder(fam).load("cpu")["params"]
    with quant("off"):
        plain = DiffusionBackbone(fam).load("cpu")["params"]
    assert not tq.is_quantized(plain["layers"]["img"]["wq"])
    with quant("int8"):
        given = DiffusionBackbone(fam, weights=plain).load("cpu")["params"]
    for key in tm._QUANT_STREAM_KEYS:
        for stream in ("img", "txt"):
            assert tq.is_quantized(own["layers"][stream][key])
            same_bits(given["layers"][stream][key]["qw"],
                      own["layers"][stream][key]["qw"])
    assert tq.is_quantized(enc["layers"][0]["mlp"]["w1"])
    assert not tq.is_quantized(enc["layers"][0]["norm1"])


# --------------------------------------------------------------------------
# (e) one forward
# --------------------------------------------------------------------------

def _forward_inputs(cfg):
    r = np.random.default_rng(0)
    lat = r.standard_normal((2, cfg.latent_size, cfg.latent_size,
                             cfg.latent_channels)).astype(np.float32)
    t = np.asarray([0.9, 0.25], np.float32)
    emb = r.standard_normal((2, cfg.text_tokens, cfg.text_dim)).astype(np.float32)
    return lat, t, emb


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_mmdit_apply_quantized_matches_jax(mode):
    jc, tc = jdiff.FAMILIES["sd3"].toy, tdiff.FAMILIES["sd3"].toy
    params = jm.init_mmdit(KEY, jc)
    tparams = from_numpy(_numpy_tree(params))
    inputs = _forward_inputs(jc)
    off = jm.mmdit_apply(params, jc, *map(jnp.asarray, inputs))
    with quant(mode):
        jqp = jm.quantize_mmdit_params(params)
        tqp = tm.quantize_mmdit_params(tparams)
    want = jm.mmdit_apply(jqp, jc, *map(jnp.asarray, inputs))
    got = tm.mmdit_apply(tqp, tc, *map(torch.from_numpy, inputs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err, control = rel_err(got.numpy(), want), rel_err(got.numpy(), off)
    assert err <= FWD_TOL[mode], err
    assert control >= (5e-3 if mode == "int8" else 1e-2), control
    # the layer loop sliced every quantized leaf: JAX's own quantized tree
    # carried across gives the same bits as the port's quantization
    carried = tm.mmdit_apply(from_numpy(_numpy_tree(jqp)), tc,
                             *map(torch.from_numpy, inputs))
    same_bits(carried, got)


def test_int8_forward_moves_with_tiny_nudges():
    """Why the int8 forward bound is not tighter: nudging the JAX package's
    own latents by 1e-7 relative (five draws) moves its int8 forward by up
    to more than the port's distance from it.  The fp32 forward moves by
    about 1e-7 under the same nudges."""
    jc, tc = jdiff.FAMILIES["sd3"].toy, tdiff.FAMILIES["sd3"].toy
    params = jm.init_mmdit(KEY, jc)
    lat, t, emb = _forward_inputs(jc)
    with quant("int8"):
        jqp = jm.quantize_mmdit_params(params)
        tqp = tm.quantize_mmdit_params(from_numpy(_numpy_tree(params)))
    forward = jax.jit(lambda x: jm.mmdit_apply(jqp, jc, x, jnp.asarray(t),
                                               jnp.asarray(emb)))
    want = np.asarray(forward(jnp.asarray(lat)))
    port = rel_err(tm.mmdit_apply(tqp, tc, *map(torch.from_numpy,
                                                (lat, t, emb))).numpy(), want)
    moves = []
    for seed in range(5):
        noise = np.random.default_rng(100 + seed).standard_normal(lat.shape)
        nudged = (lat * (1 + 1e-7 * noise)).astype(np.float32)
        moves.append(rel_err(forward(jnp.asarray(nudged)), want))
    print(f"port {port:.3e}, nudged {[f'{m:.3e}' for m in moves]}")
    assert port <= max(moves) and max(moves) > 1e-3, (port, moves)


def test_layer_slices_quantized_leaves():
    cfg = tdiff.FAMILIES["sd3"].toy
    params = tm.init_mmdit(torch.Generator().manual_seed(0), cfg)
    with quant("int8"):
        qp = tm.quantize_mmdit_params(params)
    layer = tm._layer(qp["layers"], 1)
    wq = layer["img"]["wq"]
    assert tq.is_quantized(wq)
    assert tuple(wq["qw"].shape) == (cfg.d_model, cfg.d_model)
    assert tuple(wq["qs"].shape) == (1, cfg.d_model)
    assert torch.equal(wq["qw"], qp["layers"]["img"]["wq"]["qw"][1])
    assert tuple(layer["img"]["norm1"].shape) == (cfg.d_model,)


# --------------------------------------------------------------------------
# (h) adapter pool and profile pricing (tests/test_quant.py:165-245)
# --------------------------------------------------------------------------

def _adapter(name="styleq"):
    return LoRAAdapter(tdiff.FAMILIES["sd3"], name)


def _pool():
    return AdapterPool(capacity_bytes=1 << 30, device=torch.device("cpu"))


def test_adapter_pool_bytes_use_quantized_sizes():
    with quant("off"):
        pool = _pool()
        pool.get(_adapter())
        fp32_bytes = pool.resident_bytes
    with quant("int8"):
        pool = _pool()
        comps, _ = pool.get(_adapter())
        q_bytes = pool.resident_bytes
    assert q_bytes < 0.5 * fp32_bytes
    for t in tl.TARGETS:
        q = comps["lora"][f"{t}_a"]
        assert tq.is_quantized(q) and q["qw"].dtype == torch.int8
    # the JAX package's pool sees the same shrink
    with quant("int8"):
        jpool = JAdapterPool(capacity_bytes=1 << 30)
        jpool.get(jdiff.LoRAAdapter(jdiff.FAMILIES["sd3"], "styleq"))
    assert jpool.resident_bytes == q_bytes


def test_adapter_ship_payload_is_quantized():
    """The proc plane ships exactly what the parent's pool holds
    (``adapter_pool.get(p)`` -> ``encode_value``): under int8 the wire
    payload is the small form, and it decodes to the same bits."""
    with quant("off"):
        wire_off = len(encode_value(_pool().get(_adapter())[0]))
    with quant("int8"):
        comps = _pool().get(_adapter())[0]
        wire = encode_value(comps)
        assert tq.is_quantized(comps["lora"]["wq_a"])
    assert len(wire) < 0.5 * wire_off
    got = decode_value(wire)
    for t in tl.TARGETS:
        for key in ("qw", "qs"):
            want = comps["lora"][f"{t}_a"][key]
            have = got["lora"][f"{t}_a"][key]
            assert have.dtype == want.dtype and torch.equal(have, want)


def test_adapter_pool_counters_coherent_across_quant_flip():
    pool = _pool()
    with quant("off"):
        comps_off, dt = pool.get(_adapter())
        assert (pool.misses, pool.hits) == (1, 0) and dt > 0
        bytes_off = pool.resident_bytes
    with quant("int8"):
        again, dt = pool.get(_adapter())
        assert again is comps_off and dt == 0.0
        assert (pool.misses, pool.hits) == (1, 1)
        assert pool.resident_bytes == bytes_off
        pool.drop(_adapter().model_id)
        assert pool.resident_bytes == 0
        comps_q, _ = pool.get(_adapter())
        assert (pool.misses, pool.hits) == (2, 1)
        assert pool.resident_bytes < 0.5 * bytes_off
        assert tq.is_quantized(comps_q["lora"]["wq_a"])


def test_profile_prices_quantized_forwards():
    """Backbone, segment and text encoder are quantizable, as in the JAX
    package (``quantizable=True``); the VAE prices the same in every mode."""
    fam = tdiff.FAMILIES["sd3"]
    store = ProfileStore()
    bb_model = DiffusionBackbone(fam)
    bb = store.profile_model(bb_model)
    seg = store.profile_model(bb_model.build_segment([], 4))
    enc = store.profile_model(TextEncoder(fam))
    vae = store.profile_model(VAEDecode(fam))
    for m in (bb_model, bb_model.build_segment([], 4), TextEncoder(fam)):
        assert m.cost().quantizable
    with quant("off"):
        t_off, v_off = bb.infer_time(1), vae.infer_time(1)
        s_off, e_off = seg.infer_time(1), enc.infer_time(1)
        load_off, pb_off = bb.load_time(), bb.param_bytes
    with quant("int8"):
        assert bb.infer_time(1) < 0.75 * t_off
        assert seg.infer_time(1) < s_off and enc.infer_time(1) < e_off
        assert vae.infer_time(1) == v_off
        assert bb.load_time() < load_off
        assert bb.param_bytes == 0.5 * pb_off
    with quant("fp8"):
        assert bb.infer_time(1) <= t_off
        assert bb.param_bytes == 0.5 * pb_off
    jstore = jcore.ProfileStore()
    jbb = jstore.profile_model(jdiff.ops.DiffusionBackbone(jdiff.FAMILIES["sd3"]))
    for mode in ("off", "int8", "fp8"):
        with quant(mode):
            assert bb.infer_time(1) == jbb.infer_time(1)


_FLAG_PROBE = """
import importlib, os
import repro_torch.nn.layers as l
for value in ("int8", "FP8", "0", "", "int4"):
    os.environ["REPRO_QUANT"] = value
    try:
        print(importlib.reload(l).quant_mode())
    except ValueError as e:
        print("refused", "REPRO_QUANT" in str(e))
"""


def test_quant_mode_flag_parses_like_jax():
    """``REPRO_QUANT`` is read at import, as in the JAX package; an unknown
    mode raises there and in ``set_quant_mode``."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", _FLAG_PROBE],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:5] == ["int8", "fp8", "off", "off",
                                          "refused True"]
    with pytest.raises(ValueError, match="quant mode"):
        tlayers.set_quant_mode("int4")
    assert tlayers.quant_mode() == "off"
