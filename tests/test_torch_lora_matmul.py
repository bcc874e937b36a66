"""The port's fused LoRA matmul wrappers and LoRA factor utilities against
the JAX package's, on inputs drawn from a seed with numpy.

On the CPU the port's wrappers take their plain versions; the JAX side
runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances: atol = rtol = 1e-4 for f32 and 1.5e-1 for bf16, the bounds of
``tests/test_kernels.py`` and ``tests/test_multilora.py`` (the two sides
sum in another order, and bf16 rounds at other places).  Rows without an
adapter are the port's ``qdense`` bit for bit; stacking is exact; a fold
followed by an unfold restores the weights within 1e-6 (f32 rounding of
``W + dW - dW``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import config as jc
from repro.diffusion import lora as jl
from repro.kernels.lora_matmul.ops import lora_apply as j_lora_apply
from repro.kernels.lora_matmul.ops import lora_apply_grouped as j_lora_apply_grouped
from repro_torch.diffusion import config as tcfg
from repro_torch.diffusion import lora as tl
from repro_torch.kernels.lora_matmul import kernel as tk
from repro_torch.kernels.lora_matmul.ops import lora_apply, lora_apply_grouped
from repro_torch.kernels.lora_matmul.ref import lora_matmul_masked_ref
from repro_torch.kernels.quant_matmul.ops import dequantize_weight, quantize_weight
from repro_torch.nn.layers import grouped_lora_dense, qdense
from repro_torch.weights import from_numpy

TOL = {"float32": 1e-4, "bfloat16": 1.5e-1}


def _draw(seed, *shapes, scale=None):
    r = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        x = r.standard_normal(s)
        if scale is not None and scale[i]:
            x = x / np.sqrt(scale[i])
        out.append(x.astype(np.float32))
    return out


def _both(arrs, dtype):
    """The same arrays for JAX and for the port, in ``dtype``."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


@pytest.mark.parametrize("m,k,n,r", [(128, 128, 128, 8), (200, 96, 160, 16),
                                     (64, 256, 512, 4), (300, 300, 300, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_apply_matches_jax_kernel_grid(m, k, n, r, dtype):
    """tests/test_kernels.py's grid, scale 0.7."""
    arrs = _draw(0, (m, k), (k, n), (k, r), (r, n), scale=[0, k, k, 0])
    (jx, jw, ja, jb), (x, w, a, b) = _both(arrs, dtype)
    want = j_lora_apply(jx, jw, ja, jb, scale=0.7, block_m=64, block_n=64,
                        block_k=64)
    got = lora_apply(x, w, a, b, scale=0.7)
    assert got.dtype == x.dtype and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("m,k,n,r", [
    (1, 8, 8, 1),          # single row, rank-1
    (5, 24, 40, 3),        # nothing tile-divisible
    (33, 128, 96, 8),      # m just past one block
    (128, 100, 200, 64),   # max rank, ragged K
])
def test_lora_apply_matches_jax_edge_shapes(m, k, n, r):
    """tests/test_multilora.py's edge grid, scale 1.3, with leading dims."""
    arrs = _draw(1, (m, k), (k, n), (k, r), (r, n), scale=[0, k, k, 0])
    (jx, jw, ja, jb), (x, w, a, b) = _both(arrs, "float32")
    want = j_lora_apply(jx, jw, ja, jb, scale=1.3, block_m=32, block_n=32,
                        block_k=32)
    got = lora_apply(x.reshape(1, m, k), w, a, b, scale=1.3)
    assert tuple(got.shape) == (1, m, n)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("g,r", [(1, 4), (3, 8), (4, 1), (5, 32)])
def test_lora_apply_grouped_matches_jax_kernel(g, r):
    """tests/test_multilora.py's grouped grid (M=11, K=48, N=56) plus
    G*r = 160; rows cycle through -1, 0, ..., G-1."""
    m, k, n = 11, 48, 56
    x, w, a, b = _draw(2, (m, k), (k, n), (g, k, r), (g, r, n),
                       scale=[0, k, k, 0])
    scales = np.asarray([0.5 + 0.25 * i for i in range(g)], np.float32)
    idx = np.asarray([(i % (g + 1)) - 1 for i in range(m)], np.int32)
    want = j_lora_apply_grouped(*map(jnp.asarray, (x, w, a, b, idx, scales)),
                                use_kernel=True, block_m=32, block_n=32,
                                block_k=32)
    tx, tw, ta, tb, tidx, ts = map(torch.from_numpy, (x, w, a, b, idx, scales))
    got = lora_apply_grouped(tx, tw, ta, tb, tidx, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # rows with no adapter are the port's qdense, bit for bit
    base = qdense(tx, tw)
    plain = torch.from_numpy(idx < 0)
    assert torch.equal(got[plain], base[plain])


def test_grouped_lora_dense_rows_follow_batch_index():
    """[B, S, d] activations with a per-batch-row adapter index: each
    row's slice equals the single-adapter product of its own adapter."""
    bsz, s, d, r = 3, 5, 16, 4
    h, w, a, b = _draw(3, (bsz, s, d), (d, d), (2, d, r), (2, r, d),
                       scale=[0, d, d, 0])
    th, tw, ta, tb = map(torch.from_numpy, (h, w, a, b))
    scales = torch.tensor([0.5, 2.0])
    out = grouped_lora_dense(th, tw, ta, tb, torch.tensor([1, -1, 0]), scales)
    assert torch.equal(out[1], qdense(th[1], tw))
    for row, g in ((0, 1), (2, 0)):
        want = lora_apply(th[row], tw, ta[g], tb[g], scale=float(scales[g]))
        torch.testing.assert_close(out[row], want, rtol=1e-6, atol=1e-6)
    # a quantized base is dequantized first, as in the JAX package
    q = quantize_weight(tw, "int8")
    idx = torch.tensor([0, -1, 1])
    assert torch.equal(grouped_lora_dense(th, q, ta, tb, idx, scales),
                       grouped_lora_dense(th, dequantize_weight(q), ta, tb,
                                          idx, scales))


def test_cpu_route_launches_no_kernel_and_checks_indices():
    before = (tk.lora_matmul.launches, tk.lora_matmul_grouped.launches)
    x, w, a, b = map(torch.from_numpy, _draw(4, (6, 8), (8, 8), (8, 4), (4, 8)))
    tk.lora_matmul(x, w, a, b, scale=0.5)
    tk.lora_matmul_grouped(x, w, a, b, torch.zeros(6, dtype=torch.int32),
                           torch.ones(1))
    assert (tk.lora_matmul.launches, tk.lora_matmul_grouped.launches) == before
    with pytest.raises(IndexError):
        lora_matmul_masked_ref(x, w, a, b, torch.full((6,), 2), torch.ones(2))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 cut to TF32 (the low 13 bits set to 0), as the kernel cuts."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, a_exact, b_exact, passes):
    """a @ b as the kernel forms it on the tensor cores, in f32 sums: one
    pass is hi(a) @ hi(b); more add lo(a) @ hi(b) for an f32 a and
    hi(a) @ lo(b) for an f32 b, with lo = tf32(x - hi).  A bf16 operand
    (``*_exact``) is exact in TF32 and has no low part."""
    ah = a if a_exact else _tf32(a)
    bh = b if b_exact else _tf32(b)
    out = ah @ bh
    if passes > 1 and not a_exact:
        out = out + _tf32(a - ah) @ bh
    if passes > 1 and not b_exact:
        out = out + ah @ _tf32(b - bh)
    return out


@pytest.mark.parametrize("shape,w_dtype", [
    ((256, 1536, 1536), torch.bfloat16),    # MMDiT q/k/v/o, f32 x
    ((256, 4096, 4096), torch.float32),     # text encoder, all f32
], ids=["mmdit", "text"])
def test_split_tf32_passes_hold_the_path_gate(shape, w_dtype):
    """The grouped kernel's split-TF32 products at the path's depths and
    widths (few rows): x @ W plus the masked x @ A_cat, rounded to f32 as
    the kernel stores it, then @ B_cat, with the kernel's pass count (2
    for bf16 W, 3 for f32 W) lie within the path gate 2e-5*sqrt(K/64) of
    float64, and one pass misses it.  Inputs scaled as chip_smoke.py's
    lora_inputs: x ~ N(0, 1), W and A_cat ~ N(0, 1)/sqrt(K), B_cat ~ N(0, 1)."""
    m, k, n = shape
    g, r = 2, 8
    x, w, a, b = _draw(8, (m, k), (k, n), (k, g * r), (g * r, n),
                       scale=[0, k, k, 0])
    x = torch.from_numpy(x)
    w, a, b = (torch.from_numpy(t).to(w_dtype).float() for t in (w, a, b))
    idx = torch.arange(m) * 3 // m - 1                 # blocks of -1, 0, 1
    scales = torch.tensor([0.5, 0.75])
    mask = torch.zeros((m, g * r))
    for i in range(g):
        mask[idx == i, i * r:(i + 1) * r] = scales[i]
    xd = x.double()
    want = xd @ w.double() + ((xd @ a.double()) * mask.double()) @ b.double()
    exact = w_dtype == torch.bfloat16
    passes = tk.tf32_passes(torch.float32, w_dtype)
    assert passes == (2 if exact else 3)
    gate = 2e-5 * np.sqrt(k / 64)

    def err(p):
        xa = _tf32_product(x, a, False, exact, p) * mask
        y = (_tf32_product(x, w, False, exact, p)
             + _tf32_product(xa, b, False, exact, p))
        return float((y.double() - want).abs().max())

    held, missed = err(passes), err(1)
    assert held <= gate, (held, gate)
    assert missed > gate, (missed, gate)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_stack_loras_mixed_ranks_match_jax_exactly():
    jcfg = jc.DiTConfig(d_model=16, n_layers=2, n_heads=2, d_ff=32,
                        text_dim=16, latent_size=4, latent_channels=4,
                        patch=2, text_tokens=3)
    jloras = [jl.randomize_lora(jax.random.PRNGKey(i),
                                jl.init_lora(jax.random.PRNGKey(i), jcfg,
                                             rank=rk, scale=0.5 + i))
              for i, rk in enumerate((4, 8, 2))]
    want = _numpy_tree(jl.stack_loras(jloras))
    got = tl.stack_loras([from_numpy(_numpy_tree(p)) for p in jloras])
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert tuple(got["wq_a"].shape) == (2, 3, 16, 8)   # [L, G, d, r]

    jtl = [jl.init_text_lora(jax.random.PRNGKey(10 + i), 16, rank=rk,
                             scale=1.5 - i) for i, rk in enumerate((3, 6))]
    want = _numpy_tree(jl.stack_text_loras(jtl))
    got = tl.stack_text_loras([from_numpy(_numpy_tree(p)) for p in jtl])
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_fold_unfold_roundtrip_and_fold_matches_jax():
    cfg = tcfg._TOY
    gen = torch.Generator().manual_seed(0)
    from repro_torch.diffusion.mmdit import init_mmdit

    params = init_mmdit(gen, cfg)
    lora = tl.randomize_lora(gen, tl.init_lora(gen, cfg, rank=4, scale=0.8))
    folded = tl.fold_lora(params, lora)
    assert not torch.equal(folded["layers"]["img"]["wq"],
                           params["layers"]["img"]["wq"])
    assert folded["layers"]["txt"]["wq"] is params["layers"]["txt"]["wq"]
    back = tl.unfold_lora(folded, lora)
    for t in tl.TARGETS:
        torch.testing.assert_close(back["layers"]["img"][t],
                                   params["layers"]["img"][t],
                                   rtol=0, atol=1e-6)
    # the fold is the JAX package's fold on the same arrays
    want = jl.fold_lora(jax.tree.map(jnp.asarray, _numpy_tree(params)),
                        jax.tree.map(jnp.asarray, _numpy_tree(lora)))
    for t in tl.TARGETS:
        np.testing.assert_allclose(folded["layers"]["img"][t].numpy(),
                                   np.asarray(want["layers"]["img"][t]),
                                   rtol=1e-6, atol=1e-6)

    text = {"layers": [{"wo": torch.zeros(8, 8)}, {"wo": torch.ones(8, 8)}]}
    tlo = tl.init_text_lora(gen, 8, rank=2, scale=0.5)
    f = tl.fold_text_lora(text, tlo)
    assert torch.equal(f["layers"][0]["wo"], text["layers"][0]["wo"])
    torch.testing.assert_close(tl.fold_text_lora(f, tlo, sign=-1.0)["layers"][1]["wo"],
                               text["layers"][1]["wo"], rtol=0, atol=1e-6)
