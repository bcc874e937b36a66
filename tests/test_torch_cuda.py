"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: these tests skip where no CUDA device is present, and run
on a machine with one (``python -m pytest -q -m cuda tests/test_torch_cuda.py``).
The file imports only the port, so it runs where JAX is not installed.
Flash-attention tolerances: f32 atol 2e-5, bf16 3e-2 (the JAX package's
kernel grid)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

GRID = [
    ((2, 128, 128, 64), False, None),
    ((2, 256, 256, 32), True, None),
    ((1, 200, 200, 16), True, 64),       # ragged + sliding window
    ((1, 64, 256, 64), False, None),     # cross-attention shape
    ((2, 100, 300, 8), False, 128),
    ((2, 72, 72, 16), False, None),      # toy MMDiT joint attention
    ((2, 40, 40, 1024), False, None),    # text-encoder head dim
    # f32 head dim 64 runs the tensor-core tiles: full and ragged tiles,
    # causal and window bands (bf16 takes the CUDA-core template)
    ((4, 512, 512, 64), False, None),
    ((3, 500, 500, 64), False, None),
    ((3, 500, 500, 64), True, None),
    ((2, 300, 300, 64), True, 37),
    ((1, 200, 150, 64), True, 1),        # rows 150.. see no key
    # f32 head dim 1024 runs the split-KV grid and its merge: ragged S,
    # causal and window bands with wholly masked 64-key chunks
    ((3, 100, 77, 1024), False, None),
    ((2, 333, 333, 1024), True, None),
    ((2, 333, 333, 1024), False, 40),
    ((2, 333, 333, 1024), True, 70),
    ((1, 200, 150, 1024), True, 1),
    ((1, 16, 17000, 1024), False, None),  # the merge takes 266 chunks
    # head dim 128 (Flux's heads): f32 on the wgmma route (a split-plane
    # pre-pass, then warpgroup tiles), bf16 on the CUDA-core template;
    # Flux's joint attention at published width,
    # full and ragged tiles, causal and window bands, rows with no key,
    # rectangular Sq < Sk and Sq > Sk
    ((24, 4608, 4608, 128), False, None),
    ((4, 512, 512, 128), False, None),
    ((3, 500, 500, 128), True, None),
    ((2, 300, 300, 128), True, 37),
    ((1, 200, 150, 128), True, 1),
    ((3, 100, 333, 128), False, None),
    ((2, 333, 100, 128), False, None),
    ((1, 400, 150, 128), True, 1),      # blocks that see no key tile
    # Table 2's ControlNet and LoRA workflows at published width: Flux's
    # 3-request mixed LoRA batch (no CFG rows), SD3.5-Large's ControlNet
    # branch on the latent rows (38 heads of 64)
    ((72, 4608, 4608, 128), False, None),
    ((38, 4429, 4429, 64), False, None),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window", GRID)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_kernel_matches_plain_version(card, shape, causal, window, dtype, atol):
    bh, sq, sk, d = shape
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, n, d)).astype(np.float32))
               .to(card, dtype) for n in (sq, sk, sk))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=atol)


D128 = [g for g in GRID if g[0][3] == 128]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window", D128)
def test_d128_route_gives_the_same_bits_twice(card, shape, causal, window):
    """The f32 head-dim-128 route sums in a fixed order (no atomics, no
    order that depends on timing): a second call on the same inputs gives
    the same bits."""
    bh, sq, sk, d = shape
    r = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, n, d)).astype(np.float32))
               .to(card) for n in (sq, sk, sk))
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sk", [(2, 77), (3, 333), (1, 1), (24, 4608)])
def test_split_planes_match_plain_version(card, bh, sk):
    """The f32 head-dim-128 route's pre-pass bit for bit against
    ``split_planes_ref`` (cut TF32 parts, the swizzled layout, V^T's key
    order, zero keys past a ragged Sk)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import split_planes_ref

    r = np.random.default_rng(8)
    k, v = (torch.from_numpy(r.standard_normal((bh, sk, 128)).astype(np.float32))
            .to(card) for _ in range(2))
    got = fk.split_planes(k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, split_planes_ref(k, v, tile=fk.D128_TILE))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (48, 1357, 4429, 64),     # full width, k = 4: 333 text + 4096 / 4 queries
    (2, 9 + 16, 9 + 64, 64),  # ragged: 9 text tokens, 64 image tokens, k = 4
    (3, 100, 333, 64),        # ragged query and key tiles
    (8, 24, 72, 16),          # the toy SD3 backbone at k = 4
])
def test_sequence_sharded_shapes_match_plain_version(card, shape):
    """The rectangular local-query x global-key shapes of the sequence-
    sharded MMDiT forward (Sq < Sk, non-causal), f32 against the plain
    version at atol 2e-5."""
    bh, sq, sk, d = shape
    r = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, n, d)).astype(np.float32))
               .to(card) for n in (sq, sk, sk))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, attention_ref(q, k, v), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window", [
    ((4, 333, 333, 1024), False, None),
    ((2, 333, 333, 1024), True, 70),
    ((1, 200, 150, 1024), True, 1),
    ((1, 16, 17000, 1024), False, None),
])
def test_split_kv_passes_match_plain_versions(card, shape, causal, window):
    """Each pass of the split-KV route against its plain version: the
    partials (m exactly NEG_INF and l = 0 where a chunk holds no key of a
    row), and the merge of the plain partials (f32 atol = rtol = 2e-5)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import (
        attention_partial_ref,
        merge_partials_ref,
    )

    bh, sq, sk, d = shape
    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, n, d)).astype(np.float32))
               .to(card) for n in (sq, sk, sk))
    o, m, l = fk.split_kv_partials(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    wo, wm, wl = attention_partial_ref(q, k, v, chunk=fk.SPLIT_KV_CHUNK,
                                       causal=causal, window=window)
    assert torch.equal(l > 0, wl > 0)
    assert torch.equal(m[wl == 0], wm[wl == 0])
    torch.testing.assert_close(m, wm, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(l, wl, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(o, wo, atol=2e-5, rtol=2e-5)
    merged = fk.split_kv_merge(wo, wm, wl)
    torch.cuda.synchronize()
    torch.testing.assert_close(merged, merge_partials_ref(wo, wm, wl),
                               atol=2e-5, rtol=2e-5)


# ------------------------------------------------------- fused LoRA matmul
# Tolerances: f32 1e-4, bf16 1.5e-1 (the JAX package's LoRA kernel grid).

def _lora_inputs(card, m, k, n, g, r, dtypes):
    rng = np.random.default_rng(1)
    xt, wt, ft = dtypes

    def t(shape, dt, div=1.0):
        return torch.from_numpy((rng.standard_normal(shape) / div)
                                .astype(np.float32)).to(card, dt)

    return (t((m, k), xt), t((k, n), wt, np.sqrt(k)),
            t((k, g * r), ft, np.sqrt(k)), t((g * r, n), ft))


LORA_TYPES = [((torch.float32,) * 3, 1e-4),
              ((torch.float32, torch.bfloat16, torch.bfloat16), 1e-4),
              ((torch.bfloat16,) * 3, 1.5e-1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes,tol", LORA_TYPES)
def test_lora_kernels_match_plain_versions(card, dtypes, tol):
    from repro_torch.kernels.lora_matmul import kernel as lk
    from repro_torch.kernels.lora_matmul.ref import (
        lora_matmul_masked_ref,
        lora_matmul_ref,
    )

    m, k, n, g, r = 200, 96, 160, 3, 8
    x, w, a_cat, b_cat = _lora_inputs(card, m, k, n, g, r, dtypes)
    before = (lk.lora_matmul.launches, lk.lora_matmul_grouped.launches)
    out = lk.lora_matmul(x, w, a_cat[:, :r].contiguous(),
                         b_cat[:r].contiguous(), scale=0.7)
    idx = torch.tensor([(i % (g + 1)) - 1 for i in range(m)],
                       dtype=torch.int32, device=card)
    scales = torch.tensor([0.5, 0.75, 1.0], device=card)
    outg = lk.lora_matmul_grouped(x, w, a_cat, b_cat, idx, scales)
    torch.cuda.synchronize()
    assert (lk.lora_matmul.launches, lk.lora_matmul_grouped.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == outg.dtype == x.dtype
    want = lora_matmul_ref(x, w, a_cat[:, :r], b_cat[:r], scale=0.7)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    wantg = lora_matmul_masked_ref(x, w, a_cat, b_cat, idx, scales)
    torch.testing.assert_close(outg.float(), wantg.float(), atol=tol, rtol=tol)
    # a row's base product does not depend on the other rows' adapters
    none = lk.lora_matmul_grouped(x, w, a_cat, b_cat, torch.full_like(idx, -1),
                                  scales)
    plain = idx < 0
    assert torch.equal(outg[plain], none[plain])


def _cycle_idx(card, m, g):
    return torch.tensor([(i % (g + 1)) - 1 for i in range(m)],
                        dtype=torch.int32, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtypes", [
    ((300, 4096, 520, 2, 8), (torch.float32,) * 3),          # text depth
    ((300, 1536, 520, 2, 8),
     (torch.float32, torch.bfloat16, torch.bfloat16)),       # MMDiT depth
    # Table 2's mixed LoRA batches at published width: Flux (3 requests x
    # 4096 image rows, d 3072) and SD3.5-Large (6 CFG rows x 4096, d 2432)
    ((12288, 3072, 3072, 2, 8),
     (torch.float32, torch.bfloat16, torch.bfloat16)),
    ((24576, 2432, 2432, 2, 8),
     (torch.float32, torch.bfloat16, torch.bfloat16)),
], ids=["k4096-f32", "k1536-f32-bf16", "flux-k3072", "sd35-k2432"])
def test_lora_kernels_hold_the_path_gate_at_deep_k(card, shape, dtypes):
    """Both forms at the path's depths hold the path gate, atol
    2e-5*sqrt(K/64) (rtol 0), with rows of each adapter and none; the
    idx = -1 rows are the bits of an all-(-1) batch."""
    from repro_torch.kernels.lora_matmul import kernel as lk
    from repro_torch.kernels.lora_matmul.ref import (
        lora_matmul_masked_ref,
        lora_matmul_ref,
    )

    m, k, n, g, r = shape
    atol = 2e-5 * np.sqrt(k / 64)
    x, w, a_cat, b_cat = _lora_inputs(card, m, k, n, g, r, dtypes)
    idx = _cycle_idx(card, m, g)
    scales = torch.tensor([0.5, 0.75], device=card)
    outg = lk.lora_matmul_grouped(x, w, a_cat, b_cat, idx, scales)
    a, b = a_cat[:, :r].contiguous(), b_cat[:r].contiguous()
    out = lk.lora_matmul(x, w, a, b, scale=0.7)
    none = lk.lora_matmul_grouped(x, w, a_cat, b_cat, torch.full_like(idx, -1),
                                  scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        outg, lora_matmul_masked_ref(x, w, a_cat, b_cat, idx, scales),
        atol=atol, rtol=0)
    torch.testing.assert_close(out, lora_matmul_ref(x, w, a, b, scale=0.7),
                               atol=atol, rtol=0)
    assert torch.equal(outg[idx < 0], none[idx < 0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (333, 1000, 301, 2, 8),    # N odd: W rows take element copies
    (129, 37, 130, 3, 5),      # K odd: x rows take element copies
    (257, 300, 200, 4, 64),    # G*r = 256: 8 rank K tiles, 16 column groups
    (1, 8, 8, 1, 1),
], ids=["n-odd", "k-odd", "rank-256", "one-row"])
@pytest.mark.parametrize("dtypes,tol", LORA_TYPES)
def test_lora_kernels_mask_ragged_edges(card, shape, dtypes, tol):
    """M, K and N that are no multiples of the 128 x 128 x 32 tiles, rows
    that are not 16-byte aligned, and the largest G*r, against the plain
    versions (f32 1e-4, bf16 1.5e-1); a row whose index is G is NaN."""
    from repro_torch.kernels.lora_matmul import kernel as lk
    from repro_torch.kernels.lora_matmul.ref import (
        lora_matmul_masked_ref,
        lora_matmul_ref,
    )

    m, k, n, g, r = shape
    x, w, a_cat, b_cat = _lora_inputs(card, m, k, n, g, r, dtypes)
    idx = _cycle_idx(card, m, g)
    scales = torch.tensor([0.5 + 0.25 * i for i in range(g)], device=card)
    outg = lk.lora_matmul_grouped(x, w, a_cat, b_cat, idx, scales)
    a, b = a_cat[:, :r].contiguous(), b_cat[:r].contiguous()
    out = lk.lora_matmul(x, w, a, b, scale=1.3)
    torch.cuda.synchronize()
    assert outg.shape == out.shape == (m, n)
    torch.testing.assert_close(
        outg.float(),
        lora_matmul_masked_ref(x, w, a_cat, b_cat, idx, scales).float(),
        atol=tol, rtol=tol)
    torch.testing.assert_close(
        out.float(), lora_matmul_ref(x, w, a, b, scale=1.3).float(),
        atol=tol, rtol=tol)
    bad = idx.clone()
    bad[0] = g
    poisoned = lk.lora_matmul_grouped(x, w, a_cat, b_cat, bad, scales)
    torch.cuda.synchronize()
    assert bool(poisoned[0].isnan().all())
    assert torch.equal(poisoned[1:], outg[1:])


@pytest.mark.cuda
def test_lora_kernels_refuse_what_they_do_not_take(card):
    """On the card the wrappers launch the kernel or raise: CPU operands,
    uninstantiated types and oversized ranks are refused."""
    from repro_torch.kernels.lora_matmul import kernel as lk

    x, w, a, b = _lora_inputs(card, 8, 16, 16, 1, 4, (torch.float32,) * 3)
    with pytest.raises(ValueError, match="device"):
        lk.lora_matmul(x, w.cpu(), a, b)
    with pytest.raises(ValueError, match="types"):
        lk.lora_matmul(x.to(torch.bfloat16), w.float(), a.float(), b.float())
    big_a = torch.zeros((16, 260), device=card)
    with pytest.raises(ValueError, match="rank columns"):
        lk.lora_matmul(x, w, big_a, torch.zeros((260, 16), device=card))
    with pytest.raises(ValueError, match="idx"):
        lk.lora_matmul_grouped(x, w, a, b, torch.zeros(8, dtype=torch.int64,
                                                       device=card),
                               torch.ones(1, device=card))


# ------------------------------------------------------- int8 quant matmul
# Bit for bit: the int32 accumulation is exact and the scales multiply in
# the same order in the kernel and its plain version.

QUANT_GRID = [(1, 8, 8), (5, 24, 40), (33, 128, 96), (128, 100, 200),
              (4, 1536, 9216), (1332, 1536, 1536), (300, 6144, 1540),
              # each route (128-, 64- and 16-row tiles) with ragged M, split-K
              # at M 1, 4 and 64, byte loads (K or N not a multiple of 16)
              (1, 1536, 9216), (64, 4096, 1536), (333, 4096, 4096),
              (333, 4096, 16384), (1332, 1536, 6144), (2000, 1536, 6144),
              (333, 16384, 4096), (37, 200, 130), (700, 999, 4100),
              # Table 2's int8 forms at published width: Flux (no CFG rows,
              # d 3072, d_ff 12288, ada 6d on one row) and SD3.5-Large (CFG
              # rows, d 2432, d_ff 9728)
              (4096, 3072, 12288), (4096, 12288, 3072), (1, 3072, 18432),
              (8192, 2432, 9728), (8192, 9728, 2432), (2, 2432, 14592)]


def _quant_inputs(card, m, k, n, seed=2):
    gen = torch.Generator(device=card).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=card,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device=card,
                       dtype=torch.int8)
    xs = torch.rand((m, 1), generator=gen, device=card) / 50
    ws = torch.rand((1, n), generator=gen, device=card) / 50
    return xq, wq, xs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", QUANT_GRID)
def test_quant_matmul_matches_plain_version(card, m, k, n):
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    args = _quant_inputs(card, m, k, n)
    before = quant_matmul.launches
    out = quant_matmul(*args)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    assert torch.equal(out, quant_matmul_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 1536, 9216), (64, 4096, 1536),
                                   (333, 16384, 4096), (3, 1000, 72)])
def test_quant_matmul_split_k_matches_plain_version(card, m, k, n):
    """Shapes the plan splits along K (the last with byte loads): the int32
    partial sums add exactly, so the bits do not move."""
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert qk.plan(m, k, n, sms)[1] > 1
    args = _quant_inputs(card, m, k, n, seed=4)
    assert torch.equal(qk.quant_matmul(*args), quant_matmul_ref(*args))


@pytest.mark.cuda
def test_quant_matmul_accumulates_in_int32(card):
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul

    k = 16384
    xq = torch.full((4, k), 127, dtype=torch.int8, device=card)
    wq = torch.full((k, 8), 127, dtype=torch.int8, device=card)
    ones = torch.ones((4, 1), device=card), torch.ones((1, 8), device=card)
    out = quant_matmul(xq, wq, *ones)
    assert torch.equal(out, torch.full_like(out, 127.0 * 127.0 * k))


@pytest.mark.cuda
def test_quant_matmul_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul

    xq, wq, xs, ws = _quant_inputs(card, 8, 32, 16)
    with pytest.raises(ValueError, match="device"):
        quant_matmul(xq, wq.cpu(), xs, ws)
    with pytest.raises(ValueError, match="int8"):
        quant_matmul(xq.float(), wq, xs, ws)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(xq, wq.t(), xs, ws.reshape(1, 16))
    with pytest.raises(ValueError, match="shapes"):
        quant_matmul(xq, wq, xs, ws[:, :8].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_weight_holds_one_layer_of_temporaries(card, mode):
    """A layer-stacked bf16 leaf (Flux's ``ada``, [L, 3072, 18432], cut to
    8 layers) quantizes one layer at a time: the peak above the input is
    the quantized output and a few float32 copies of one layer (the whole
    leaf in float32 is 1.8 GB, twice the bound), and the bits are the
    whole-leaf quantization's."""
    from repro_torch.kernels.quant_matmul.ops import (
        _quantize_matrix,
        quantize_weight,
    )

    gen = torch.Generator(device=card).manual_seed(3)
    w = (torch.randn((8, 3072, 18432), generator=gen, device=card)
         * 0.02).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    q = quantize_weight(w, mode)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    out_bytes = sum(t.numel() * t.element_size() for t in q.values())
    layer_f32 = 3072 * 18432 * 4
    assert peak <= out_bytes + 4 * layer_f32, (peak, out_bytes, layer_f32)
    whole = _quantize_matrix(w, mode)
    assert torch.equal(q["qw"].view(torch.uint8), whole["qw"].view(torch.uint8))
    assert torch.equal(q["qs"], whole["qs"])


# ------------------------------------------------- activation quantization
# Bit for bit: the kernel repeats the plain version's float32 operations.

def _rows_probe(card, m, k, seed=6):
    """Normal draws, an all-zero row, and a row of exact .5 quotients (row
    maximum 127, so the scale is 1)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32) * 3
    x[0] = 0.0
    if m > 1:
        x[1] = r.integers(-127, 127, k).astype(np.float32) + 0.5
        x[1, 0] = 127.0
    return torch.from_numpy(x).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(4, 1536), (16384, 1536), (1332, 6144),
                                 (333, 4096), (333, 16384), (1, 17),
                                 (37, 1000), (9, 1001), (5, 3001), (3, 20000),
                                 (2, 40000), (2, 40001), (4096, 12288),
                                 (1, 3072), (8192, 9728), (2, 2432)])
def test_quantize_rows_matches_plain_version(card, m, k):
    """The int8 path's shapes (32 to 512 threads a row), ragged K (K % 4 !=
    0 takes element loads), and rows too long to hold in registers."""
    from repro_torch.kernels.quant_matmul.kernel import quantize_rows
    from repro_torch.kernels.quant_matmul.ref import quantize_rows_ref

    x = _rows_probe(card, m, k)
    before = quantize_rows.launches
    xq, xs = quantize_rows(x)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1
    want_q, want_s = quantize_rows_ref(x)
    assert xq.dtype == torch.int8 and xs.shape == (m, 1)
    assert torch.equal(xq, want_q) and torch.equal(xs, want_s)


@pytest.mark.cuda
def test_quantize_rows_nan_row_and_refusals(card):
    """A row holding a NaN gets scale 1, as the plain version's NaN-keeping
    maximum gives, and its finite entries the plain version's values; a
    non-contiguous or non-float32 input raises."""
    from repro_torch.kernels.quant_matmul.kernel import quantize_rows
    from repro_torch.kernels.quant_matmul.ref import quantize_rows_ref

    x = _rows_probe(card, 4, 1536)
    x[2, 7] = float("nan")
    xq, xs = quantize_rows(x)
    want_q, want_s = quantize_rows_ref(x)
    assert torch.equal(xs, want_s) and float(xs[2]) == 1.0
    finite = torch.isfinite(x)
    assert torch.equal(xq[finite], want_q[finite])
    with pytest.raises(ValueError, match="contiguous"):
        quantize_rows(x.t())
    with pytest.raises(ValueError, match="float32"):
        quantize_rows(x.double())


# ------------------------------------------------------------ RG-LRU scan
# Tolerance 2e-5 (the JAX package's kernel grid): the kernel steps through
# time, the plain version is a log-depth associative scan.

@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", [(2, 128, 128), (1, 200, 96), (3, 64, 256),
                                   (2, 300, 50), (1, 8192, 2560)])
def test_rglru_kernel_matches_plain_version(card, b, t, d):
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_ref

    gen = torch.Generator(device=card).manual_seed(3)
    a = torch.sigmoid(torch.randn((b, t, d), generator=gen, device=card))
    x = torch.randn((b, t, d), generator=gen, device=card)
    before = rglru_scan.launches
    out = rglru_scan(a, x)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    torch.testing.assert_close(out, rglru_ref(a, x), atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="float32"):
        rglru_scan(a.double(), x.double())


def literal_f64(a, x):
    """The recurrence step by step in float64 on the inputs' device."""
    a, x = a.double(), x.double()
    g = torch.sqrt(torch.clamp(1 - a * a, min=0.0)) * x
    out, h = torch.empty_like(a), torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + g[:, t]
        out[:, t] = h
    return out


# Long memory: a uniform in [0.99, 0.9999] (RecurrentGemma's published
# initialisation), so a carry lives for hundreds of steps and crosses the
# kernel's 256-step tiles.  Kernel against plain at 2e-5; both against the
# float64 literal recurrence at 5e-5 absolute and relative (float32
# roundings add up over the memory length: 7.7e-6 at (1, 8192, 2560) on the
# H100).
@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", [(1, 8192, 2560), (8, 2048, 2560),
                                   (2, 3001, 50), (3, 1, 7)])
def test_rglru_kernel_long_memory(card, b, t, d):
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_ref

    gen = torch.Generator(device=card).manual_seed(5)
    a = 0.99 + 0.0099 * torch.rand((b, t, d), generator=gen, device=card)
    x = torch.randn((b, t, d), generator=gen, device=card)
    out = rglru_scan(a, x)
    torch.cuda.synchronize()
    plain = rglru_ref(a, x)
    torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)
    want = literal_f64(a, x)
    for got in (out, plain):
        torch.testing.assert_close(got.double(), want, atol=5e-5, rtol=5e-5)
    # the look-back folds its carry in one order: the same bits every call
    assert torch.equal(rglru_scan(a, x), out)


# --------------------------------------------------------------------------
# the hybrid LLM family: the card against the CPU on the same weights
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_hybrid_llm_on_the_card_matches_cpu(card):
    """recurrentgemma-2b reduced to 4 layers (one (r, r, a) super-block and
    a remainder block): the prefill launches ``rglru_scan`` once per RG-LRU
    block (3) and its last logits, and 8 decode steps, are within 1e-4
    relative of the CPU run (the plain scan) on the same weights."""
    import dataclasses

    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan
    from repro_torch.models import get_family, make_prefill_step, make_serve_step
    from repro_torch.weights import to_device

    cfg = dataclasses.replace(ARCHS["recurrentgemma-2b"].reduced(), n_layers=4)
    fam = get_family(cfg)
    params = fam.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    want = make_prefill_step(cfg)(params, {"tokens": tokens})
    gparams = to_device(params, card)
    before = rglru_scan.launches
    got = make_prefill_step(cfg)(gparams, {"tokens": tokens.to(card)})
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 3
    assert got.device.type == "cuda" and _rel(got, want) < 1e-4
    step = make_serve_step(cfg)
    ccache = fam.init_decode_cache(cfg, 2, 16, dtype=torch.float32,
                                   device="cpu")
    gcache = fam.init_decode_cache(cfg, 2, 16, dtype=torch.float32,
                                   device=card)
    for t in range(8):
        want, ccache = step(params, ccache, tokens[:, t])
        got, gcache = step(gparams, gcache, tokens[:, t].to(card))
        assert _rel(got, want) < 1e-4, t


# --------------------------------------------------------------------------
# the ControlNet workflows: the card against the CPU on the same weights
# --------------------------------------------------------------------------

def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
def test_vae_encode_on_the_card_matches_cpu(card):
    """Three stride-2 convs (TF32 off in cuDNN): within 1e-5 relative."""
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.diffusion import SD3
    from repro_torch.diffusion.encoders import vae_encode
    from repro_torch.diffusion.ops import VAEDecode
    from repro_torch.weights import to_device

    params = VAEDecode(SD3).load("cpu")["params"]
    img = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (2, 256, 256, 3)).astype(np.float32))
    want = vae_encode(params, img)
    got = vae_encode(to_device(params, card), img.to(card))
    assert got.device.type == "cuda" and tuple(got.shape) == (2, 32, 32, 4)
    assert _rel(got, want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n_cns", [1, 2])
def test_controlnet_workflow_on_the_card_matches_cpu(card, n_cns):
    """The toy sd3:cn1 / sd3:cn2 request served on the card and on the CPU
    from the same weights (the ControlNets with a nonzero ``cond_embed``)
    and latents: within 1e-4 relative, through the flash-attention kernel."""
    import repro_torch.core as tcore
    import repro_torch.diffusion as tdiff

    cpu_ms, gpu_ms = tdiff.ModelSet(tdiff.SD3), tdiff.ModelSet(tdiff.SD3)
    for name in ("text_enc", "backbone", "vae_dec", "cn1", "cn2"):
        params = getattr(cpu_ms, name).load("cpu")["params"]
        if name.startswith("cn"):
            gen = torch.Generator().manual_seed(int(name[-1]))
            ce = params["cond_embed"]
            params = {**params, "cond_embed": torch.randn(
                tuple(ce.shape), generator=gen) / ce.shape[0] ** 0.5}
        for ms in (cpu_ms, gpu_ms):
            getattr(ms, name).weights = params
            if name == "vae_dec":
                ms.vae_enc.weights = params
    ref = np.random.default_rng(6).uniform(-1, 1, (1, 128, 128, 3)).astype(
        np.float32)
    images = {}
    for dev, ms in (("cuda", gpu_ms), ("cpu", cpu_ms)):
        system = tcore.ServingSystem(n_executors=1,
                                     backend=tcore.LocalBackend(device=dev))
        wf = tdiff.make_controlnet_workflow("sd3", n_cns, ms)
        system.register(wf)
        before = flash_attention.launches
        req = system.submit(wf.name, inputs={"seed": 3, "prompt": "a fox",
                                             "ref_image": torch.from_numpy(ref)},
                            steps=3)
        system.run()
        assert req.status == "done"
        images[dev] = system.coordinator.engine.value_of(
            req.ref_key(req.graph.outputs["image"]))
        if dev == "cuda":
            assert flash_attention.launches > before
    assert images["cuda"].device.type == "cuda"
    assert _rel(images["cuda"], images["cpu"]) < 1e-4


# --------------------------------------------------------------------------
# the serving launcher's local plane on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_launcher_local_plane_flags_bitexact(card):
    """The launcher's local plane (the first 8 requests of an S1 trace, 3
    steps, one executor) at the toy size on the card, once with
    ``REPRO_DONATE`` and ``REPRO_OVERLAP`` off and once with both on: the
    same requests finish, with bit-identical images."""
    from repro_torch.core.runtime import set_overlap
    from repro_torch.diffusion.sampler import set_donate_buffers
    from repro_torch.launch.serve import parse_args, serve
    from repro_torch.sim import check_invariants

    images = {}
    for flags in (False, True):
        prev = (set_donate_buffers(flags), set_overlap(flags))
        try:
            system = serve(parse_args(["--plane", "local", "--executors", "1",
                                       "--device", "cuda"]))
        finally:
            set_donate_buffers(prev[0])
            set_overlap(prev[1])
        c = system.coordinator
        assert c.overlap is flags and check_invariants(c) == []
        assert len(c.finished) + len(c.rejected) == 8 and c.finished
        images[flags] = {r.rid: c.engine.value_of(
            r.ref_key(r.graph.outputs["image"])) for r in c.finished}
    assert sorted(images[True]) == sorted(images[False])
    for rid, img in images[False].items():
        assert img.device.type == "cuda"
        assert torch.equal(img, images[True][rid]), rid


# --------------------------------------------------------------------------
# the process plane on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn, torch.int8])
def test_to_portable_takes_card_tensors_to_the_cpu(card, dtype):
    """A CUDA tensor leaves ``to_portable`` (and the wire) as a CPU tensor
    with the same dtype and bits."""
    from repro_torch.core.transport import decode_value, encode_value, to_portable

    r = np.random.default_rng(4)
    base = torch.from_numpy(r.standard_normal((6, 5)).astype(np.float32) * 9)
    t = (base.to(torch.int8) if dtype == torch.int8 else base.to(dtype)).to(card)
    for got in (to_portable({"x": [t]})["x"][0],
                decode_value(encode_value({"x": [t]}))["x"][0]):
        assert got.device.type == "cpu" and got.dtype == dtype
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           t.cpu().reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_proc_plane_on_the_card_matches_local(card, monkeypatch):
    """The toy ``sd3:basic`` request on ``ProcBackend(device="cuda")`` (one
    worker with its own CUDA context) is bit-identical to
    ``LocalBackend(device="cuda")``; every reply reaches the parent as CPU
    tensors; a seeded adapter lands on the card."""
    from repro_torch.core import (
        LocalBackend,
        ProcBackend,
        ProcConfig,
        ServingSystem,
        processes_available,
    )
    from repro_torch.core import transport
    from repro_torch.core.executor import AdapterPool
    from repro_torch.diffusion import SD3, LoRAAdapter, make_basic_workflow

    if not processes_available():
        pytest.skip("cannot spawn worker processes")
    seen = []
    real_split = transport.split_frames

    def spy(buf):
        msgs = real_split(buf)
        for m in msgs:
            for out in m.get("outs") or ():
                seen.extend(v for v in out.values()
                            if isinstance(v, torch.Tensor))
        return msgs

    monkeypatch.setattr(transport, "split_frames", spy)
    images = {}
    for name, backend in (
            ("local", LocalBackend(device="cuda")),
            ("proc", ProcBackend(ProcConfig(spawn_timeout=120.0,
                                            exec_wall_timeout=120.0),
                                 device="cuda"))):
        system = ServingSystem(n_executors=1, backend=backend)
        system.register(make_basic_workflow("sd3"))
        with system:
            req = system.submit("sd3:basic",
                                inputs={"seed": 0, "prompt": "a fox"},
                                arrival=0.0, steps=3)
            system.run()
            assert req.status == "done"
            images[name] = system.coordinator.engine.value_of(
                req.ref_key(req.graph.outputs["image"]))
    assert images["local"].device.type == "cuda"
    assert images["proc"].device.type == "cpu"
    assert seen and all(t.device.type == "cpu" for t in seen)
    assert torch.equal(images["proc"], images["local"].cpu())
    comps = LoRAAdapter(SD3, "seeded").load("cpu")
    pool = AdapterPool(1 << 30, device=card)
    pool.seed("lora:seeded:sd3", comps)
    assert pool._entries["lora:seeded:sd3"]["lora"]["wq_a"].device.type == "cuda"


# --------------------------------------------------------------------------
# the training path: the backward kernels and a train step on the card
# --------------------------------------------------------------------------

# Flash-attention backward: dq, dk, dv against attention_bwd_ref on the same
# inputs (and the kernel's own lse) within 1e-5 of max(1, max |ref|) (f32
# sums in another order; at head dim 64 split-TF32 products, which keep
# about 20 bits), the same bits on a second call.  The head-dim-64 shapes
# cross the 64-row tiles' edges.
FLASH_BWD_GRID = [
    ((2, 128, 128, 64), False, None),
    ((2, 256, 256, 32), True, None),
    ((1, 200, 200, 16), True, 64),
    ((1, 64, 256, 64), False, None),
    ((2, 100, 300, 8), False, 128),
    ((3, 500, 500, 64), True, None),
    ((2, 300, 300, 64), True, 37),
    ((1, 200, 150, 64), True, 1),      # rows 150.. see no key
    ((24, 1500, 1500, 64), False, None),  # whisper-tiny's encoder
    ((2, 130, 190, 64), False, None),  # neither a multiple of the tile
    ((2, 37, 50, 64), False, None),    # both inside one tile
    ((2, 300, 20, 64), True, None),    # Sk under a tile, Sq > Sk
    ((2, 700, 129, 64), False, None),  # Sq > Sk
    ((2, 129, 700, 64), False, None),  # Sq < Sk
    ((1, 100, 300, 64), True, None),   # keys 100.. seen by no row
    ((2, 260, 260, 64), False, 20),    # a window narrower than a tile
    ((1, 333, 333, 64), True, 5),
    ((1, 1500, 1500, 64), False, None),   # BH 1
    ((160, 256, 256, 64), False, None),   # 1280 blocks, 5 per SM
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window", FLASH_BWD_GRID)
def test_flash_attention_bwd_matches_plain_version(card, shape, causal, window):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref,
        attention_lse_ref,
    )

    bh, sq, sk, d = shape
    r = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(r.standard_normal((bh, n, d))
                                    .astype(np.float32)).to(card)
                   for n in (sq, sk, sk, sq))
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=True)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            window=window))
    want_lse = attention_lse_ref(q, k, causal=causal, window=window)
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isinf(lse), ~seen)
    torch.testing.assert_close(lse[seen], want_lse[seen], atol=1e-5, rtol=1e-5)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                             window=window)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * max(1.0, float(w.abs().max()))
    again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_flash_autograd_on_the_card_launches_the_backward_kernel(card):
    """mha with inputs that need gradients: one forward and one backward
    launch, gradients within 1e-5 of autograd through the plain version;
    bf16 and head dim 1024 have no backward kernel and raise."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import mha

    gen = torch.Generator(device=card).manual_seed(8)
    q, k, v, do = (torch.randn((2, 300, 6, 64), generator=gen, device=card)
                   for _ in range(4))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fk.flash_attention.launches, fk.flash_attention_bwd.launches)
    grads = torch.autograd.grad(mha(*xs), xs, do)
    torch.cuda.synchronize()
    assert (fk.flash_attention.launches - before[0],
            fk.flash_attention_bwd.launches - before[1]) == (1, 1)
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    flat = [y.permute(0, 2, 1, 3).reshape(12, 300, 64) for y in ys]
    plain = attention_ref(*flat).reshape(2, 6, 300, 64).permute(0, 2, 1, 3)
    want = torch.autograd.grad(plain, ys, do)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    for dt, d in ((torch.bfloat16, 64), (torch.float32, 1024)):
        t = torch.randn((1, 40, 2, d), device=card).to(dt).requires_grad_()
        with pytest.raises(ValueError, match="no backward kernel"):
            mha(t, t, t)


# RG-LRU backward: against rglru_bwd_ref within 3e-6 relative (max |diff|
# over max |ref|), and on long-memory gates both against the float64 literal
# reverse recurrence within 1e-4 relative (da's slope -a / sqrt(1 - a^2)
# magnifies the rounding of 1 - a^2, for the plain version as for the
# kernel: 3.6e-5 at (1, 4096, 2560) on the H100, chip_smoke.py phase 9h).
def literal_bwd_f64(a, x, h, dh):
    a, x, h, dh = (t.double() for t in (a, x, h, dh))
    y = 1 - a * a
    root = torch.sqrt(torch.clamp(y, min=0.0))
    slope = torch.where(y > 0, -a / torch.where(y > 0, root, 1.0), 0.0)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    g, da, dx = torch.zeros_like(a[:, 0]), torch.empty_like(a), torch.empty_like(a)
    for t in range(a.shape[1] - 1, -1, -1):
        g = dh[:, t] + (a[:, t + 1] * g if t + 1 < a.shape[1] else 0.0)
        dx[:, t] = g * root[:, t]
        da[:, t] = g * (h_prev[:, t] + x[:, t] * slope[:, t])
    return da, dx


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", [(2, 128, 128), (1, 200, 96), (2, 300, 50),
                                   (2, 3001, 50), (3, 1, 7), (1, 4096, 2560)])
@pytest.mark.parametrize("long_memory", [False, True])
def test_rglru_bwd_kernel_matches_plain_version(card, b, t, d, long_memory):
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref

    gen = torch.Generator(device=card).manual_seed(9)
    if long_memory:
        a = 0.99 + 0.0099 * torch.rand((b, t, d), generator=gen, device=card)
    else:
        a = torch.sigmoid(torch.randn((b, t, d), generator=gen, device=card))
    x, dh = (torch.randn((b, t, d), generator=gen, device=card) for _ in range(2))
    h = rglru_scan(a, x)
    before = rglru_scan_bwd.launches
    got = rglru_scan_bwd(a, x, h, dh)
    torch.cuda.synchronize()
    assert rglru_scan_bwd.launches == before + 1
    want = rglru_bwd_ref(a, x, h, dh)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= 3e-6
    assert all(torch.equal(p, q) for p, q in zip(got, rglru_scan_bwd(a, x, h, dh)))
    if long_memory and t <= 4096:
        cut = slice(0, min(d, 256))           # the float64 loop on 256 channels
        lit = literal_bwd_f64(*(u[..., cut] for u in (a, x, h, dh)))
        for ours in (got, want):
            for g, w in zip(ours, lit):
                assert float((g[..., cut].double() - w).abs().max()
                             / w.abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="float32"):
        rglru_scan_bwd(a.double(), x.double(), h.double(), dh.double())


@pytest.mark.cuda
@pytest.mark.parametrize("name,layers", [("whisper-tiny", None),
                                         ("recurrentgemma-2b", 5)])
def test_train_step_on_the_card_matches_cpu(card, name, layers):
    """One AdamW step at ``reduced()`` (recurrentgemma at 5 layers: a
    rematerialised super-block and a remainder) on the card and on the CPU
    from the same weights and batch: the loss and the moments within 1e-4
    relative; the card launches the forward and backward kernels."""
    import dataclasses

    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.models import get_family, make_train_step
    from repro_torch.train import adamw_init
    from repro_torch.train.tree import paths
    from repro_torch.weights import to_device

    cfg = ARCHS[name].reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = get_family(cfg).init(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (2, 32), generator=gen)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                      generator=gen)
    gparams = to_device(params, card)
    gbatch = to_device(batch, card)
    step = make_train_step(cfg)
    _, cstate, cm = step(params, adamw_init(params), batch)
    counters = (fk.flash_attention, fk.flash_attention_bwd, rk.rglru_scan,
                rk.rglru_scan_bwd)
    before = [c.launches for c in counters]
    _, gstate, gm = step(gparams, adamw_init(gparams), gbatch)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    if name == "whisper-tiny":      # the encoder's layers, not rematerialised
        assert launched == [cfg.encoder_layers, cfg.encoder_layers, 0, 0]
    else:                           # 2 + 2 recomputed + 2 remainder; 4
        assert launched == [0, 0, 6, 4]
    assert abs(float(gm["loss"]) - float(cm["loss"])) <= 1e-4 * float(cm["loss"])
    for field in ("mu", "nu"):
        want = dict(paths(getattr(cstate, field)))
        for key, leaf in paths(getattr(gstate, field)):
            assert _rel(leaf, want[key]) <= 1e-4, (field, key)
