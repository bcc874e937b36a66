"""Shared neural-net primitives, PyTorch port (the diffusion main path).

Plain functions on tensors: ``init_*`` builds parameter dicts, the other
functions consume them.  Layouts follow the JAX package: activations are
``[B, S, d]`` and attention is ``[B, S, H, D]``.  Weights are stored
``[d_in, d_out]`` and applied as ``h @ w``.

Dtype rules mirror JAX's promotion explicitly, because torch does not
promote mixed-dtype matmuls: a projection computes in the wider of the
activation's and the weight's dtype (f32 activations against bf16 weights
compute in f32), and the result keeps that dtype.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

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
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal draw on the generator's device, scaled in f32, then cast —
    the JAX package's ``dense_init`` order."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
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


# ---------------------------------------------------------------- attention

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
    """Grouped-query attention.

    The non-causal, mask-free square case (the MMDiT joint attention and
    the text encoder) routes through the flash-attention kernel under the
    same conditions as the JAX package; everything else takes the plain
    dense path.  The JAX package's blockwise long-sequence and long-cache
    decode paths serve its LLM families, which are not ported yet.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if (_flash_enabled and not causal and window is None and mask is None
            and q_offset == 0 and softmax_scale is None and sq == sk
            and sq <= 8192):
        from repro_torch.kernels.flash_attention.ops import mha

        return mha(q, k, v, causal=False)
    kr = k.repeat_interleave(group, dim=2) if group > 1 else k
    vr = v.repeat_interleave(group, dim=2) if group > 1 else v
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


# --------------------------------------------------------------------- MLPs

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
