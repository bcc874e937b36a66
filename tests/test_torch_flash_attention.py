"""The port's flash-attention module against the JAX package's.

On the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` does.  Same
grid as that file (ragged, windowed, causal and rectangular shapes).
Tolerances: f32 atol 2e-5, bf16 3e-2 (the JAX grid's own).  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ops import mha as j_mha
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import (
    attention_partial_ref,
    attention_ref,
    merge_partials_ref,
)
from repro_torch.nn import layers as tl

GRID = [
    ((2, 128, 128, 64), False, None, 64, 64),
    ((2, 256, 256, 32), True, None, 64, 128),
    ((1, 200, 200, 16), True, 64, 64, 64),      # ragged + sliding window
    ((1, 64, 256, 64), False, None, 32, 64),    # cross-attention shape
    ((2, 100, 300, 8), False, 128, 32, 128),
    # head dim 128 (Flux's heads): ragged with causal and window bands,
    # and a rectangular Sq != Sk shape
    ((1, 200, 200, 128), True, 48, 64, 64),
    ((2, 72, 200, 128), False, None, 32, 64),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(shape, jdt, tdt, seed=0):
    bh, sq, sk, d = shape
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal((bh, n, d)).astype(np.float32)
            for n in (sq, sk, sk)]
    j = [jnp.asarray(a, jdt) for a in arrs]
    # identical values on both sides: bf16 inputs are rounded once, by JAX
    t = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in j]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape,causal,window,bq,bk", GRID)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_jax(shape, causal, window, bq, bk, dtype):
    _, jdt, tdt, atol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, jdt, tdt)
    want_kernel = j_flash(jq, jk, jv, causal=causal, window=window,
                          block_q=bq, block_k=bk)
    want_ref = j_ref(jq, jk, jv, causal=causal, window=window)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    got_ref = attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == tq.shape
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=atol)
        np.testing.assert_allclose(_f32(got_ref), _f32(want), atol=atol,
                                   rtol=atol)


def test_fully_masked_rows_give_zero():
    """Window 1 + causal on a rectangular shape leaves rows with no key:
    they output 0, like the TPU kernel."""
    r = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(r.standard_normal((1, n, 8)).astype(np.float32))
               for n in (6, 3, 3))
    out = flash_attention(q, k, v, causal=True, window=1)
    want = j_ref(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                 causal=True, window=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)
    assert torch.all(out[0, 3:] == 0)


@pytest.mark.parametrize("heads,causal", [((8, 2), True), ((4, 4), False),
                                          ((6, 3), False)])
def test_mha_matches_jax(heads, causal):
    hq, hkv = heads
    r = np.random.default_rng(2)
    q = r.standard_normal((2, 64, hq, 32)).astype(np.float32)
    k = r.standard_normal((2, 64, hkv, 32)).astype(np.float32)
    v = r.standard_normal((2, 64, hkv, 32)).astype(np.float32)
    got = mha(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = j_mha(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # the plain version on the [B*H, S, D] view, kv heads expanded
    def heads(x):
        x = torch.from_numpy(x).repeat_interleave(hq // x.shape[2], dim=2)
        return x.permute(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])
    plain = attention_ref(heads(q), heads(k), heads(v), causal=causal)
    plain = plain.reshape(2, hq, 64, 32).permute(0, 2, 1, 3)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("kw,routed", [
    (dict(), True),
    (dict(causal=True), False),
    (dict(window=4), False),
    (dict(q_offset=2), False),
    (dict(softmax_scale=0.5), False),
    (dict(mask="zeros"), False),
], ids=["joint", "causal", "window", "offset", "scale", "mask"])
def test_gqa_attention_flash_route_conditions(monkeypatch, kw, routed):
    calls = []

    def spy(q, k, v, **k_):
        calls.append(q.shape)
        return mha(q, k, v, **k_)

    monkeypatch.setattr("repro_torch.kernels.flash_attention.ops.mha", spy)
    x = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(0))
    if kw.get("mask") == "zeros":
        kw = dict(mask=torch.zeros(1, 1, 8, 8))
    tl.gqa_attention(x, x, x, **kw)
    assert bool(calls) == routed
    # the rectangular and the long (> 8192) square cases stay plain too
    calls.clear()
    tl.gqa_attention(x[:, :4], x, x)
    assert not calls


def test_flash_route_flag(monkeypatch):
    calls = []
    monkeypatch.setattr("repro_torch.kernels.flash_attention.ops.mha",
                        lambda *a, **k: calls.append(1))
    x = torch.randn(1, 8, 2, 16)
    prev = tl.set_flash_attention(False)
    try:
        tl.gqa_attention(x, x, x)
        assert not calls
        tl.set_flash_attention(True)
        tl.gqa_attention(x, x, x)
        assert calls == [1]
    finally:
        tl.set_flash_attention(prev)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    before = flash_attention.launches
    x = torch.randn(2, 16, 16)
    out = flash_attention(x, x, x)
    torch.testing.assert_close(out, attention_ref(x, x, x), rtol=0, atol=0)
    assert flash_attention.launches == before


def test_non_cpu_tensor_launches_or_raises_never_falls_back(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version:
    the wrapper checks it, builds and launches the kernel, or raises.  A
    meta tensor (the dry run's trace) takes the meta route, which computes
    nothing and counts no launch."""
    plain_calls = []
    monkeypatch.setattr(fa_kernel, "attention_ref",
                        lambda *a, **k: plain_calls.append(1))
    x = torch.empty(2, 16, 16, device="meta")
    before = flash_attention.launches
    out = flash_attention(x, x, x)
    assert out.device.type == "meta" and out.shape == x.shape
    assert plain_calls == [] and flash_attention.launches == before
    # a tensor on another device: the checks refuse it
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("xpu")))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(x, x, x)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    # with the tensor checks passed (as for a real CUDA tensor), a missing
    # kernel build raises instead of running the plain version
    monkeypatch.setattr(fa_kernel, "_check", lambda *a: None)

    def no_kernel():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(fa_kernel, "_kernel", no_kernel)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        flash_attention(x, x, x)
    assert plain_calls == [] and flash_attention.launches == before


@pytest.mark.parametrize("d,ok", [(64, True), (1024, True), (48, False),
                                  (128, True), (96, False), (256, False)])
def test_kernel_checks_head_dim(monkeypatch, d, ok):
    """The wrapper raises on a head dim the kernel has no tile shape for."""
    x = torch.empty(1, 4, d, device="meta")
    monkeypatch.setattr(torch.Tensor, "is_contiguous", lambda self: True)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    if ok:
        fa_kernel._check(x, x, x)
    else:
        with pytest.raises(ValueError, match="head dim"):
            fa_kernel._check(x, x, x)


# ------------------------------------------- the CUDA kernel's arithmetic
# The kernel cannot run here.  What it computes at head dims 64, 128 and
# 1024 is emulated in plain torch: 3xTF32 products (split-precision TF32 on
# the tensor cores, f32 sums; at head dim 128 q k^T sums D in two chains of
# 8 k steps joined by an f32 add, as the kernel does) and the split-KV
# partials and their merge.  The head-dim-128 route's order of sums (its
# key tiles, online softmax and tensor-core chains, each product's sum
# truncated) is emulated with ``tile``.

def _tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """f32 reduced to TF32 (10 mantissa bits): cut (the low 13 bits set to
    0, as the kernel's ``split`` does) or rounded to nearest with ties away
    from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int, rounding):
    """a @ b with TF32 operands and f32 sums: one pass (hi * hi), or three
    (hi * hi + hi * lo + lo * hi, with lo = tf32(x - hi))."""
    ah, bh = _tf32(a, rounding), _tf32(b, rounding)
    out = ah @ bh
    if passes == 3:
        out = (out + ah @ _tf32(b - bh, rounding)
               + _tf32(a - ah, rounding) @ bh)
    return out


def _truncated_chain(a, b, passes, rounding, acc=None):
    """acc + a @ b on the tensor cores: TF32 operands (one pass, or lo * hi,
    hi * lo, hi * hi), each product an instruction of 8 k steps whose exact
    sum with the accumulator is truncated toward zero to f32, as the tensor
    cores truncate as they accumulate.  Values are f32 held in float64
    (the sum of 8 exact TF32 products and an f32 loses nothing there);
    a and b are [batch, rows, k] and [batch, k, cols]."""
    ah, bh = _tf32(a, rounding), _tf32(b, rounding)
    al, bl = _tf32(a - ah, rounding), _tf32(b - bh, rounding)
    terms = ([(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)])
    terms = [(x.double(), y.double()) for x, y in terms]
    acc = (torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
           if acc is None else acc.clone())
    cut = ~((1 << 29) - 1)       # float64 mantissa bits below f32's 24
    for i in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc.baddbmm_(x[..., i:i + 8], y[..., i:i + 8, :])
            acc.view(torch.int64).bitwise_and_(cut)
    return acc


def _tile_order(q, k, v, passes, rounding, chain, tile, pv, rows=1152):
    """The head-dim-128 route's order of sums: q pre-scaled by
    scale*log2(e); S = q k^T in truncated chains of ``chain`` dims joined
    by f32 adds; an online softmax (exp2, running max and sum in f32) over
    key tiles of ``tile``; P v either in a fresh truncated chain per tile
    joined to the output by a rounded f32 FMA (``pv="fresh"``, the kernel's
    order) or accumulated into the rescaled output itself (``"in place"``).
    Query rows are independent: they go in blocks of ``rows``."""
    scale_log2 = np.float32(np.log2(np.e) / np.sqrt(q.shape[-1]))
    out = []
    for r0 in range(0, q.shape[-2], rows):
        qs = q[..., r0:r0 + rows, :] * scale_log2
        s = None
        for c in range(0, q.shape[-1], chain):
            part = _truncated_chain(
                qs[..., c:c + chain],
                k[..., c:c + chain].transpose(-1, -2).contiguous(),
                passes, rounding).float()
            s = part if s is None else s + part
        m = torch.full(s.shape[:-1] + (1,), -1e30)
        l = torch.zeros(s.shape[:-1] + (1,))
        o = torch.zeros(s.shape[:-1] + v.shape[-1:], dtype=torch.float64)
        for t0 in range(0, k.shape[-2], tile):
            st = s[..., t0:t0 + tile]
            m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(st - m_new)
            l, m = alpha * l + p.sum(dim=-1, keepdim=True), m_new
            vt = v[..., t0:t0 + tile, :]
            if pv == "fresh":
                o = (o * alpha.double()
                     + _truncated_chain(p, vt, passes, rounding)).float()
            else:
                o = _truncated_chain(p, vt, passes, rounding,
                                     (o * alpha.double()).float().double())
            o = o.double()
        out.append(o.float() / l)
    return torch.cat(out, dim=-2)


def _tf32_attention(q, k, v, passes, rounding, chain=None, tile=None,
                    pv="fresh"):
    """3xTF32 (or one-pass) attention; with ``chain``, q k^T sums D in
    chains of that many dims, each joined to the running sum by an f32
    add; with ``tile``, in the head-dim-128 route's order (``_tile_order``)."""
    if tile is not None:
        # thousands of small ops: one thread each, or the test workers'
        # thread pools, several to a core, stall one another
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return _tile_order(q, k, v, passes, rounding,
                               chain or q.shape[-1], tile, pv)
        finally:
            torch.set_num_threads(threads)
    q = q / np.sqrt(q.shape[-1])
    chain = chain or q.shape[-1]
    s = sum(_tf32_product(q[..., c:c + chain],
                          k[..., c:c + chain].transpose(-1, -2), passes,
                          rounding)
            for c in range(0, q.shape[-1], chain))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (_tf32_product(p, v, passes, rounding)
            / p.sum(dim=-1, keepdim=True))


@pytest.mark.parametrize("rounding", ["cut", "rna"])
@pytest.mark.parametrize("shape,chain,tile", [
    ((1, 4429, 4429, 64), None, None),
    ((1, 4608, 4608, 128), 64, None),   # Flux's joint attention, D in 2 chains
    ((1, 333, 333, 1024), None, None),
    # the head-dim-128 route's order: 32-key tiles, truncated sums
    ((1, 4608, 4608, 128), 64, 32),
], ids=["mmdit", "flux", "text", "flux-wgmma"])
def test_split_tf32_products_hold_the_f32_gate(shape, chain, tile, rounding):
    """3xTF32 attention lies within the f32 gate (2e-5) of the float64
    reference at the path's sequence lengths, and one TF32 pass misses it:
    the gate tells the two apart, so the kernel needs the three passes.
    The kernel cuts its operands to TF32; rounding them to nearest holds
    the gate too.  At head dim 128 the kernel sums q k^T's two 64-wide
    halves of D in chains of 8 k steps and adds them in f32; the
    head-dim-128 route (``flux-wgmma``) does so in its own order, every
    tensor-core sum truncated, P v a fresh chain of 4 k steps a 32-key
    tile joined to the output by an f32 FMA."""
    bh, sq, sk, d = shape
    r = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, n, d)).astype(np.float32))
               for n in (sq, sk, sk))
    qd, kd, vd = q.double(), k.double(), v.double()
    want = torch.softmax(qd @ kd.transpose(-1, -2) / np.sqrt(d), dim=-1) @ vd
    err3 = float((_tf32_attention(q, k, v, 3, rounding, chain, tile).double()
                  - want).abs().max())
    err1 = float((_tf32_attention(q, k, v, 1, rounding, chain, tile).double()
                  - want).abs().max())
    assert err3 <= 2e-5, err3
    assert err1 > 2e-5, err1


@pytest.mark.parametrize("rounding", ["cut", "rna"])
def test_in_place_output_chain_misses_the_f32_gate(rounding):
    """Why the head-dim-128 route sums P v of each tile into fresh
    registers: accumulated into the output itself, P v is one truncated
    chain over all 4608 keys (1728 products), and its bias toward zero
    grows with the output.  With values whose mean is not 0 (V + 1, as
    activations have) that order misses the f32 gate at Flux's key length
    and the route's fresh chains hold it with room.  Query rows are
    independent, so 512 of them stand for Flux's 4608."""
    r = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(r.standard_normal((1, n, 128)).astype(np.float32))
               for n in (512, 4608, 4608))
    v = v + 1.0
    want = (torch.softmax(q.double() @ k.double().transpose(-1, -2)
                          / np.sqrt(128), dim=-1) @ v.double())
    errs = {pv: float((_tf32_attention(q, k, v, 3, rounding, 64, 32, pv)
                       .double() - want).abs().max())
            for pv in ("fresh", "in place")}
    assert errs["fresh"] <= 2e-5 / 4, errs
    assert errs["in place"] > 2e-5, errs


def test_split_planes_hold_both_parts_in_the_kernels_layout():
    """The head-dim-128 pre-pass's plain version on a ragged Sk (77 keys,
    3 tiles of 32): each plane is a permutation of its tile's values, K hi
    and lo (and V^T's) are the TF32 cut of x and of x - hi, hi + lo is x
    to 2^-21, keys past Sk are zero, and V^T's slots hold each 8-key group
    in the order 0 2 4 6 1 3 5 7.  The wrapper takes it on the CPU and
    counts no launch."""
    from repro_torch.kernels.flash_attention.ref import (
        _sw128,
        split_planes_ref,
    )
    r = np.random.default_rng(5)
    k, v = (torch.from_numpy(r.standard_normal((2, 77, 128)).astype(np.float32))
            for _ in range(2))
    before = flash_attention.launches
    planes = fa_kernel.split_planes(k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(planes, split_planes_ref(k, v), rtol=0, atol=0)
    assert planes.shape == (2, 3, 4, 32 * 128)
    # undo the layout: float index of (key row, dim) and (dim row, slot)
    rows, dims, slots = (torch.arange(32)[:, None], torch.arange(128)[None, :],
                         torch.arange(32)[None, :])
    k_at = ((dims // 32) * 32 * 128 + _sw128(rows, dims % 32)) // 4
    v_at = _sw128(dims.T, slots) // 4
    for at in (k_at, v_at):
        assert sorted(at.reshape(-1).tolist()) == list(range(32 * 128))
    perm = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    key_of = 8 * (torch.arange(32) // 8) + perm[torch.arange(32) % 8]
    pad = torch.zeros(2, 96 - 77, 128)
    for x, lo_i, at, transpose in ((k, 0, k_at, False), (v, 2, v_at, True)):
        full = torch.cat([x, pad], dim=1).view(2, 3, 32, 128)
        if transpose:           # [BH, tile, dim row, slot]
            full = full[:, :, key_of, :].transpose(-1, -2)
        hi = planes[:, :, lo_i][..., at]
        lo = planes[:, :, lo_i + 1][..., at]
        cut = lambda y: (y.contiguous().view(torch.int32)
                         & ~0x1FFF).view(torch.float32)
        assert torch.equal(hi, cut(full))
        assert torch.equal(lo, cut(full - cut(full)))
        assert float((hi + lo - full).abs().max()) <= 2 ** -21 * float(
            full.abs().max())
    assert torch.all(planes[:, 2, :2][..., k_at][:, :, 77 - 64:, :] == 0)


def _tf32_attention_bwd(q, k, v, o, lse, do, mask, passes):
    """The backward kernel's head-dim-64 arithmetic in plain torch: every
    product in TF32 (operands cut, f32 sums), one pass or three.  Its dK/dV
    sweep forms S^T = K Q^T and dP^T = V dO^T, its dQ sweep S and dP again:
    the same products, so one emulation stands for both."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
    s = _tf32_product(q, kt, passes, "cut")
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]), 0.0)
    dp = _tf32_product(do, vt, passes, "cut")
    ds = p * (dp - (do * o).sum(dim=-1, keepdim=True))
    return (_tf32_product(ds, k, passes, "cut") * scale,
            _tf32_product(ds.transpose(-1, -2), q, passes, "cut") * scale,
            _tf32_product(p.transpose(-1, -2), do, passes, "cut"))


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 1500, 1500, 64), False, None),     # whisper-tiny's encoder
    ((2, 700, 500, 64), True, None),
    ((2, 600, 600, 64), False, 100),
], ids=["whisper", "causal", "window"])
def test_split_tf32_backward_holds_the_f32_gate(shape, causal, window):
    """The backward kernel's five products in 3xTF32 lie within its gate
    (1e-5 of max(1, max |ref|), ``FLASH_BWD_TOL``) of the float64 backward
    of the same f32 inputs for dq, dk and dv, and in one TF32 pass each
    misses it: the gate needs the three passes."""
    bh, sq, sk, d = shape
    r = np.random.default_rng(9)
    q, k, v, do = (torch.from_numpy(r.standard_normal((bh, n, d))
                                    .astype(np.float32))
                   for n in (sq, sk, sk, sq))
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    qd, kd, vd, dod = q.double(), k.double(), v.double(), do.double()
    s = (qd @ kd.transpose(-1, -2) / np.sqrt(d)).masked_fill(~mask, -np.inf)
    o = (torch.softmax(s, dim=-1) @ vd).float()
    lse = torch.logsumexp(s, dim=-1).float()
    p = torch.where(mask, torch.exp(s - lse.double()[..., None]), 0.0)
    ds = p * (dod @ vd.transpose(-1, -2)
              - (dod * o.double()).sum(dim=-1, keepdim=True))
    want = (ds @ kd / np.sqrt(d), ds.transpose(-1, -2) @ qd / np.sqrt(d),
            p.transpose(-1, -2) @ dod)
    for passes, holds in ((3, True), (1, False)):
        got = _tf32_attention_bwd(q, k, v, o, lse, do, mask, passes)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = float((g.double() - w).abs().max())
            gate = 1e-5 * max(1.0, float(w.abs().max()))
            assert (err <= gate) == holds, (passes, name, err, gate)


@pytest.mark.parametrize("chunk", [16, 64, 100, 333])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 333, 333, 64), False, None),
    ((2, 333, 333, 64), True, None),        # later chunks wholly masked
    ((2, 333, 333, 64), False, 40),         # earlier chunks wholly masked
    ((1, 200, 150, 64), True, 1),           # rows 150.. see no key at all
], ids=["full", "causal", "window", "rows-masked"])
def test_split_kv_partials_merge_to_attention(shape, causal, window, chunk):
    """The split-KV kernel's plain versions: per-chunk partials merged
    across chunks equal the whole attention within 1e-6, with wholly
    masked chunks adding nothing and an all-masked row giving 0."""
    bh, sq, sk, d = shape
    r = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, n, d)).astype(np.float32))
               for n in (sq, sk, sk))
    o, m, l = attention_partial_ref(q, k, v, chunk=chunk, causal=causal,
                                    window=window)
    assert o.shape == (-(-sk // chunk), bh, sq, d)
    got = merge_partials_ref(o, m, l)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    if (causal or window) and chunk < sk:
        assert bool((l == 0).any())         # some chunk holds no key of a row
    if window == 1:
        assert torch.all(got[:, sk:] == 0)


def test_split_kv_wrappers_take_plain_versions_on_the_cpu():
    """On the CPU the split-KV pass wrappers run the plain versions, in
    chunks of the kernel's width, and count no launch."""
    r = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(r.standard_normal((1, n, 1024)).astype(np.float32))
               for n in (70, 150, 150))
    before = flash_attention.launches
    o, m, l = fa_kernel.split_kv_partials(q, k, v, causal=True)
    assert o.shape == (3, 1, 70, 1024)
    got = fa_kernel.split_kv_merge(o, m, l)
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=True),
                               atol=1e-6, rtol=0)
    assert flash_attention.launches == before
