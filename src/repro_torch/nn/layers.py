"""Shared neural-net primitives, PyTorch port.

Used by both the diffusion substrate (:mod:`repro_torch.diffusion`) and
the LLM families (:mod:`repro_torch.models`).  Plain functions on tensors:
``init_*`` builds parameter dicts, the other functions consume them.  Layouts follow the JAX package: activations are
``[B, S, d]`` and attention is ``[B, S, H, D]``.  Weights are stored
``[d_in, d_out]`` and applied as ``h @ w``.

Dtype rules mirror JAX's promotion explicitly, because torch does not
promote mixed-dtype matmuls: a projection computes in the wider of the
activation's and the weight's dtype (f32 activations against bf16 weights
compute in f32), and the result keeps that dtype.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F

from repro_torch.kernels import meta
from repro_torch.kernels.lora_matmul.ops import lora_apply_grouped
from repro_torch.kernels.quant_matmul.ops import (
    dequantize_weight,
    is_quantized,
    quant_apply,
    quantize_weight,
)

Params = Dict[str, Any]


# ------------------------------------------------- flash-attention routing
#
# The non-causal, mask-free attention path (the MMDiT joint text+image
# hot path, the text encoder) routes through the flash-attention kernel
# (repro_torch.kernels.flash_attention): the hand-written CUDA kernel for
# a CUDA tensor, its plain version for a CPU tensor.
# ``REPRO_FLASH_ATTENTION=0`` (or set_flash_attention(False)) routes the
# plain attention path instead.

_flash_enabled: bool = os.environ.get(
    "REPRO_FLASH_ATTENTION", "1").lower() not in ("0", "false", "off")


def set_flash_attention(enabled: bool) -> bool:
    """Toggle the flash-attention route; returns the previous value.
    Read at every call (PyTorch runs eagerly)."""
    global _flash_enabled
    prev = _flash_enabled
    _flash_enabled = bool(enabled)
    return prev


def flash_attention_enabled() -> bool:
    return _flash_enabled


# ------------------------------------------------- quantized-forward routing
#
# Weight quantization (``REPRO_QUANT=int8|fp8|off``, default off), read at
# import as in the JAX package.  The mode is consulted when parameters are
# materialised (model load, LoRA fold), not inside the applies: those are
# structure-driven, taking the quantized route for a ``{"qw", "qs"}`` dict
# (see :mod:`repro_torch.kernels.quant_matmul.ops`) and the plain route
# for a tensor.

_QUANT_MODES = ("off", "int8", "fp8")
_quant_mode: str = os.environ.get("REPRO_QUANT", "off").lower()
if _quant_mode in ("", "0", "false"):
    _quant_mode = "off"
if _quant_mode not in _QUANT_MODES:
    raise ValueError(
        f"REPRO_QUANT={_quant_mode!r}: expected one of {_QUANT_MODES}")


def set_quant_mode(mode: str) -> str:
    """Set the weight-quantization mode (``off``/``int8``/``fp8``);
    returns the previous mode.  Takes effect on the next model load or
    LoRA fold: components already materialised keep their form."""
    global _quant_mode
    if mode not in _QUANT_MODES:
        raise ValueError(f"quant mode {mode!r}: expected one of {_QUANT_MODES}")
    prev = _quant_mode
    _quant_mode = mode
    return prev


def quant_mode() -> str:
    return _quant_mode


def quantize_dense(w: Any) -> Any:
    """Quantize one dense projection weight per the active mode (the
    identity when ``off`` or already quantized)."""
    if _quant_mode == "off":
        return w
    return quantize_weight(w, _quant_mode)


def qdense(h: torch.Tensor, w: Any) -> torch.Tensor:
    """Dense projection: a ``[d_in, d_out]`` tensor weight computes ``h @ w``
    with JAX's dtype promotion; a quantized dict takes the quantized route
    (float32 out, as in the JAX package)."""
    if is_quantized(w):
        return quant_apply(h, w["qw"], w["qs"])
    dt = torch.promote_types(h.dtype, w.dtype)
    return h.to(dt) @ w.to(dt)


# ----------------------------------------------------- grouped LoRA dense

def grouped_lora_dense(
    h: torch.Tensor,            # [B, S, d_in]
    w: Any,                     # [d_in, d_out], or a quantized dict
    a: torch.Tensor,            # [G, d_in, r]  stacked adapter A factors
    b: torch.Tensor,            # [G, r, d_out] stacked adapter B factors
    idx: torch.Tensor,          # [B] int32 adapter per batch row; -1 = none
    scales: torch.Tensor,       # [G]
) -> torch.Tensor:
    """Dense projection with a per-row grouped multi-LoRA delta:
    ``h @ w + scales[idx] * (h @ a[idx]) @ b[idx]``, one forward for a batch
    mixing G tenants, through the grouped ``lora_matmul`` kernel (its plain
    version for CPU tensors, where rows with ``idx < 0`` equal
    :func:`qdense` of a tensor weight bit for bit).  A quantized base is
    dequantized first, as in the JAX package: the grouped kernel needs the
    dense weight."""
    w = dequantize_weight(w)
    bsz, s, d_in = h.shape
    rows_idx = idx.to(torch.int32).repeat_interleave(s)
    out = lora_apply_grouped(h.reshape(bsz * s, d_in), w, a, b, rows_idx,
                             scales)
    return out.reshape(bsz, s, w.shape[1])


# ---------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None, device: Any = None
               ) -> torch.Tensor:
    """Normal draw on ``device`` (the generator's device by default, and the
    generator must live there), scaled in f32, then cast — the JAX
    package's ``dense_init`` order."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device or gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32, device: Any = None
               ) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device or gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32) -> Params:
    return {
        "w1": dense_init(gen, d_model, d_ff, dtype),
        "b1": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
        "w2": dense_init(gen, d_ff, d_model, dtype),
        "b2": torch.zeros((d_model,), dtype=dtype, device=gen.device),
    }


# -------------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * w).to(dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * w + b).to(dtype)


# --------------------------------------------------------------------- RoPE

@functools.lru_cache(maxsize=16)
def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     dtype: torch.dtype = torch.float32, device: Any = "cpu"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)``, each ``[max_seq, head_dim / 2]``: computed in numpy
    float64 and then cast, as the JAX package does.  Cached (16 tables):
    a decode step asks for the same table every call, and the callers
    never write to it."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_seq), inv)
    return (torch.from_numpy(np.cos(freqs)).to(device=device, dtype=dtype),
            torch.from_numpy(np.sin(freqs)).to(device=device, dtype=dtype))


def _take_rows(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, positions, axis=0)``: rows past the end read NaN
    (JAX's default ``fill`` mode) instead of raising."""
    n = table.shape[0]
    out = table[positions.clamp(max=n - 1)]
    return torch.where((positions >= n)[..., None],
                       torch.full_like(out, float("nan")), out)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [max_seq, head_dim/2]."""
    if positions is not None:
        cos = _take_rows(cos, positions)
        sin = _take_rows(sin, positions)
    else:
        cos = cos[: x.shape[-3]]
        sin = sin[: x.shape[-3]]
    cos = cos[..., :, None, :]          # broadcast over the head axis
    sin = sin[..., :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def update_slice_(dst: torch.Tensor, src: torch.Tensor, start: int,
                  dim: int = 1) -> torch.Tensor:
    """Write ``src`` into ``dst`` along ``dim`` from ``start``, in place,
    with ``start`` clamped into ``[0, dst.size(dim) - src.size(dim)]`` as
    ``jax.lax.dynamic_update_slice_in_dim`` clamps it.  Returns ``dst``."""
    n = src.shape[dim]
    start = min(max(int(start), 0), dst.shape[dim] - n)
    dst.narrow(dim, start, n).copy_(src)
    return dst


# ---------------------------------------------------------------- attention

def _blockwise_attention(
    q: torch.Tensor,              # [B, Sq, H, D] (kv already head-repeated)
    k: torch.Tensor,              # [B, Sk, H, D]
    v: torch.Tensor,
    causal: bool,
    window: Optional[int],
    scale: float,
    block_q: int = 1024,
    block_k: int = 1024,
) -> torch.Tensor:
    """Blockwise online-softmax attention in plain torch: live memory
    O(block_q x block_k) per head instead of O(S^2).  The JAX package's
    ``lax.map`` over query blocks and ``lax.scan`` over key blocks are two
    Python loops."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    pq, pk = (-sq) % block_q, (-sk) % block_k
    q = F.pad(q, (0, 0, 0, 0, 0, pq))
    k = F.pad(k, (0, 0, 0, 0, 0, pk))
    v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = (sq + pq) // block_q, (sk + pk) // block_k
    qb = q.reshape(b, nq, block_q, h, d).permute(1, 0, 3, 2, 4)  # [nq,b,h,bq,d]
    kb = k.reshape(b, nk, block_k, h, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, block_k, h, d).permute(1, 0, 3, 2, 4)
    neg = torch.finfo(torch.float32).min
    dev = q.device
    outs = []
    for qi in range(nq):
        qtile = qb[qi].float() * scale
        qpos = qi * block_q + torch.arange(block_q, device=dev)[:, None]
        m = torch.full((b, h, block_q), neg, device=dev)
        l = torch.zeros((b, h, block_q), device=dev)
        acc = torch.zeros((b, h, block_q, d), device=dev)
        for ki in range(nk):
            s = torch.einsum("bhqd,bhkd->bhqk", qtile, kb[ki].float())
            kpos = ki * block_k + torch.arange(block_k, device=dev)[None, :]
            mask = kpos < sk
            if causal:
                mask = mask & (kpos <= qpos)
            if window is not None:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask[None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask[None, None], torch.exp(s - m_new[..., None]),
                            0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vb[ki].float())
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        outs.append(acc / l[..., None])                   # [b,h,bq,d]
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, sq + pq, h, d)
    return out[:, :sq].to(q.dtype)


def _blockwise_decode(
    q: torch.Tensor,              # [B, Sq<=128, Hq, D]
    k: torch.Tensor,              # [B, Sk, Hkv, D]   (long cache)
    v: torch.Tensor,
    mask: torch.Tensor,           # [B, 1, Sq, Sk] additive
    scale: float,
    group: int,
    block_k: int = 2048,
) -> torch.Tensor:
    """Decode attention over a long KV cache, blockwise with online
    softmax: the GQA head repeat and the f32 upcast happen per K tile, so
    the deep cache is never materialised repeated or in f32."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    pk = (-sk) % block_k
    neg = torch.finfo(torch.float32).min
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        mask = F.pad(mask, (0, pk), value=neg)
    qf = q.float() * scale
    dev = q.device
    m = torch.full((b, hq, sq), neg, device=dev)
    l = torch.zeros((b, hq, sq), device=dev)
    acc = torch.zeros((b, hq, sq, d), device=dev)
    for lo in range(0, sk + pk, block_k):
        kt = k[:, lo:lo + block_k].repeat_interleave(group, dim=2).float()
        vt = v[:, lo:lo + block_k].repeat_interleave(group, dim=2).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) + mask[..., lo:lo + block_k]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s <= neg / 2, 0.0, p)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, vt).permute(0, 2, 1, 3)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None]                              # [b,hq,sq,d]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def gqa_attention(
    q: torch.Tensor,              # [B, Sq, Hq, D]
    k: torch.Tensor,              # [B, Sk, Hkv, D]
    v: torch.Tensor,              # [B, Sk, Hkv, D]
    causal: bool = False,
    window: Optional[int] = None,          # sliding-window size (causal)
    q_offset: int = 0,                     # absolute position of q[0]
    mask: Optional[torch.Tensor] = None,   # extra additive mask [B,1,Sq,Sk]
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention, routed as in the JAX package.

    * The non-causal, mask-free square case (the MMDiT joint attention,
      the text encoder, whisper's encoder) goes through the flash-attention
      kernel unless :func:`set_flash_attention` turned it off.
    * Decode against a long cache (a mask, Sk > 8192, Sq <= 128) takes the
      grouped blockwise decode, which never repeats the deep cache.
    * Other long sequences (Sq > 8192, no mask) take the blockwise
      online-softmax path.
    * Everything else, the LLM families' causal and windowed attention
      among it, takes the plain dense path.

    ``DTensor`` inputs (the dry run's trace) have their kv heads repeated
    to the query heads, then run on their batch and head shards (heads
    that do not divide the model axis split as far as they do).
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    if meta.is_dtensor(q):
        if group > 1:
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        # every caller's mask is the same for each batch row: a shard
        # takes its first rows
        return meta.on_local_shards(
            lambda q, k, v: gqa_attention(
                q, k, v, causal=causal, window=window, q_offset=q_offset,
                mask=None if mask is None else mask[:q.shape[0]],
                softmax_scale=softmax_scale), (q, k, v), (0, 2), spread=(2,))
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if (_flash_enabled and not causal and window is None and mask is None
            and q_offset == 0 and softmax_scale is None and sq == sk
            and sq <= 8192):
        from repro_torch.kernels.flash_attention.ops import mha

        return mha(q, k, v, causal=False)
    if mask is not None and sk > 8192 and sq <= 128:
        return _blockwise_decode(q, k, v, mask, scale, group)
    kr = k.repeat_interleave(group, dim=2) if group > 1 else k
    vr = v.repeat_interleave(group, dim=2) if group > 1 else v
    if mask is None and sq > 8192:
        return _blockwise_attention(q, kr, vr, causal, window, scale)
    qf = q.float() * scale
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kr.float())
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    neg = torch.finfo(torch.float32).min
    if causal:
        logits = logits.masked_fill((kpos > qpos)[None, None], neg)
    if window is not None:
        logits = logits.masked_fill((kpos <= qpos - window)[None, None], neg)
    if mask is not None:
        logits = logits + mask  # [B, 1, Sq, Sk]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr.float())
    return out.to(q.dtype)


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: Optional[int] = None,
                   dtype: torch.dtype = torch.float32, qk_norm: bool = False,
                   device: Any = "cuda") -> Params:
    head_dim = head_dim or d_model // n_heads
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device=device),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype, device=device),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype, device=device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device=device),
    }
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=device)
    return p


def attention_block(
    p: Params,
    x: torch.Tensor,                    # [B, S, d_model]
    n_heads: int,
    n_kv: int,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: int = 0,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Full attention sublayer with an optional KV cache.

    With ``kv_cache``: writes this call's K/V at ``cache_index`` (clamped
    as in the JAX package) into copies of the cache and attends over the
    whole cache with position masking; returns the new cache."""
    b, s, _ = x.shape
    head_dim = p["wq"].shape[1] // n_heads
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    new_cache = None
    if kv_cache is not None:
        idx = int(cache_index)
        ck = update_slice_(kv_cache[0].clone(), k.to(kv_cache[0].dtype), idx)
        cv = update_slice_(kv_cache[1].clone(), v.to(kv_cache[1].dtype), idx)
        new_cache = (ck, cv)
        # mask out the slots not written yet, and with a window the slots
        # before it (over absolute positions)
        kpos = torch.arange(ck.shape[1], device=x.device)
        neg = torch.finfo(torch.float32).min
        amask = torch.where(kpos < idx + s, 0.0, neg)[None, None, None, :]
        if window is None:
            amask = amask.expand(b, 1, s, ck.shape[1])
        else:
            qpos = idx + torch.arange(s, device=x.device)[:, None]
            wmask = torch.where(kpos[None, :] <= qpos - window, neg, 0.0)
            amask = amask + wmask[None, None]
        out = gqa_attention(q, ck, cv, causal=False, q_offset=idx, mask=amask)
    else:
        out = gqa_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(b, s, n_heads * head_dim)
    return out @ p["wo"], new_cache


# --------------------------------------------------------------------- MLPs

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype = torch.float32, device: Any = "cuda"
                ) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device=device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device=device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device=device),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return qdense(gelu(qdense(x, p["w1"]) + p["b1"]), p["w2"]) + p["b2"]


# ------------------------------------------------------------- embeddings

def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of diffusion timesteps; t: [B] float in [0,1]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, device=t.device, dtype=torch.float32)
                      / half)
    args = t[:, None].float() * freqs[None] * 1000.0
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x * (1+scale) + shift, broadcast over sequence."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def mask_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Suppress padded vocab columns (finite -1e9, softmax-safe)."""
    vp = logits.shape[-1]
    if vp == vocab:
        return logits
    pad = torch.arange(vp, device=logits.device) >= vocab
    return logits + pad.to(logits.dtype) * torch.tensor(
        -1e9, dtype=logits.dtype, device=logits.device)
