"""LoRA adapters for the MMDiT backbone (§2.1, weight-patching adapters),
PyTorch port.

A LoRA targets the image-stream attention projections of every layer:
``W' = W + scale * A @ B`` with ``A: [L, d, r]``, ``B: [L, r, d]``.

Two application modes:

* :func:`fold_lora` — functional weight update, used when every request of
  a batch carries the same adapter;
* the grouped :mod:`repro_torch.kernels.lora_matmul` kernel — computes
  ``xW + s(xA)B`` per row without materialising ``W'``, which keeps one
  *shared* base-model replica clean while a batch mixes tenants.

Under ``REPRO_QUANT`` base weights and adapter factors may be quantized
``{"qw", "qs"}`` dicts.  Folding dequantizes the target, adds the low-rank
delta in float32 and requantizes in the base's mode (quantize-on-fold), so
the fold cache keeps the small form; stacking dequantizes the factors for
the grouped kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from repro_torch.diffusion.config import DiTConfig
from repro_torch.kernels.quant_matmul.ops import (
    dequantize_weight,
    is_quantized,
    quantize_weight,
)
from repro_torch.nn.layers import quant_mode

Params = Dict[str, Any]

TARGETS = ("wq", "wk", "wv", "wo")

# ------------------------------------------------- quantization awareness

_FACTOR_KEYS = tuple(f"{t}_{s}" for t in TARGETS for s in ("a", "b"))


def _mode_of(q: Params) -> str:
    return "int8" if q["qw"].dtype == torch.int8 else "fp8"


def _requant_like(w: torch.Tensor, base: Params) -> Params:
    """``w`` quantized the way the quantized ``base`` was."""
    return quantize_weight(w, _mode_of(base))


def quantize_lora(lora: Params) -> Params:
    """A backbone adapter's A/B factors quantized per the active
    ``REPRO_QUANT`` mode (the identity when off): the adapter pool then
    holds the small form."""
    mode = quant_mode()
    if mode == "off":
        return lora
    return {k: (quantize_weight(v, mode) if k in _FACTOR_KEYS else v)
            for k, v in lora.items()}


def quantize_text_lora(tl: Params) -> Params:
    """Quantized-factor form of a text-encoder adapter (see
    :func:`quantize_lora`)."""
    mode = quant_mode()
    if mode == "off":
        return tl
    return {k: (quantize_weight(v, mode) if k in ("a", "b") else v)
            for k, v in tl.items()}


def init_lora(gen: torch.Generator, cfg: DiTConfig, rank: int = 8,
              scale: float = 1.0) -> Params:
    """Adapter factors drawn on the generator's device: A normal over
    ``sqrt(d)``, B zero (the standard LoRA init)."""
    d, dev = cfg.d_model, gen.device
    p: Params = {"scale": torch.tensor(scale, dtype=cfg.dtype, device=dev)}
    for t in TARGETS:
        a = torch.randn((cfg.n_layers, d, rank), generator=gen, device=dev,
                        dtype=torch.float32)
        p[f"{t}_a"] = (a * (1.0 / math.sqrt(d))).to(cfg.dtype)
        p[f"{t}_b"] = torch.zeros((cfg.n_layers, rank, d), dtype=cfg.dtype,
                                  device=dev)
    return p


def randomize_lora(gen: torch.Generator, lora: Params,
                   amplitude: float = 0.02) -> Params:
    """Give the zero-init B matrices content (for tests and examples)."""
    out = dict(lora)
    for t in TARGETS:
        b = lora[f"{t}_b"]
        draw = torch.randn(b.shape, generator=gen, device=b.device,
                           dtype=torch.float32)
        out[f"{t}_b"] = (draw * amplitude).to(b.dtype)
    return out


def fold_lora(params: Params, lora: Params) -> Params:
    """Backbone params with the LoRA folded into the image-stream attention
    weights.  Purely functional: the original tree is intact, so a shared
    replica can serve other requests.  The delta is cast to the base
    weight's dtype before the add, as the JAX package does: with bf16
    weights the folded weight is ``W + ΔW`` rounded to bf16.  A quantized
    target is dequantized, takes the delta in float32 and is requantized
    in its own mode."""
    scale = lora["scale"]
    new_layers = dict(params["layers"])
    new_img = dict(new_layers["img"])
    for t in TARGETS:
        a = dequantize_weight(lora[f"{t}_a"])
        b = dequantize_weight(lora[f"{t}_b"])
        delta = torch.einsum("ldr,lre->lde", a, b) * scale
        base = new_layers["img"][t]
        if is_quantized(base):
            new_img[t] = _requant_like(dequantize_weight(base) + delta, base)
        else:
            new_img[t] = base + delta.to(base.dtype)
    new_layers["img"] = new_img
    out = dict(params)
    out["layers"] = new_layers
    return out


def unfold_lora(params: Params, lora: Params) -> Params:
    """Inverse of :func:`fold_lora` (restore the pristine base weights, up
    to rounding)."""
    neg = dict(lora)
    neg["scale"] = -lora["scale"]
    return fold_lora(params, neg)


def _pad_rank(x: torch.Tensor, axis: int, rank: int) -> torch.Tensor:
    pad = rank - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    # zero rank columns contribute exactly 0
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def stack_loras(loras: Sequence[Params]) -> Params:
    """Stack G per-adapter LoRA params into the grouped layout the batched
    multi-LoRA forward consumes.

    Adapters with different ranks are zero-padded to the largest rank
    (exact: extra zero columns of A / rows of B contribute nothing).
    Returns, per target ``t``:

    * ``{t}_a``: ``[L, G, d, r]`` and ``{t}_b``: ``[L, G, r, d]`` — the layer
      axis LEADS, so layer ``l`` of the stack is the ``[G, d, r]`` factors
      the forward's layer loop hands that layer;
    * ``scales``: ``[G]`` f32.
    """
    if not loras:
        raise ValueError("stack_loras needs at least one adapter")
    loras = [{k: (dequantize_weight(v) if k in _FACTOR_KEYS else v)
              for k, v in p.items()} for p in loras]
    rank = max(p[f"{TARGETS[0]}_a"].shape[-1] for p in loras)
    out: Params = {"scales": torch.stack([
        torch.as_tensor(p["scale"], dtype=torch.float32) for p in loras])}
    for t in TARGETS:
        a = torch.stack([_pad_rank(p[f"{t}_a"], 2, rank) for p in loras])
        b = torch.stack([_pad_rank(p[f"{t}_b"], 1, rank) for p in loras])
        out[f"{t}_a"] = a.permute(1, 0, 2, 3).contiguous()   # [L,G,d,r]
        out[f"{t}_b"] = b.permute(1, 0, 2, 3).contiguous()   # [L,G,r,d]
    return out


# ------------------------------------------------- text-encoder adapters
#
# A lightweight companion to the backbone LoRA: a low-rank delta on the
# LAST text-encoder layer's output projection (``wo``).  Folding adds
# ``scale * a @ b`` to that weight; the grouped path applies it per row.

def init_text_lora(gen: torch.Generator, d_model: int, rank: int = 8,
                   scale: float = 1.0, amplitude: float = 0.02,
                   dtype: torch.dtype = torch.float32) -> Params:
    dev = gen.device
    a = torch.randn((d_model, rank), generator=gen, device=dev,
                    dtype=torch.float32)
    b = torch.randn((rank, d_model), generator=gen, device=dev,
                    dtype=torch.float32)
    return {
        "a": (a * (1.0 / math.sqrt(d_model))).to(dtype),
        "b": (b * amplitude).to(dtype),
        "scale": torch.tensor(scale, dtype=dtype, device=dev),
    }


def fold_text_lora(params: Params, tl: Params, sign: float = 1.0) -> Params:
    """Text-encoder params with the adapter folded into the last layer's
    ``wo`` (functional; a quantized ``wo`` is requantized as in
    :func:`fold_lora`)."""
    delta = (dequantize_weight(tl["a"]) @ dequantize_weight(tl["b"])) \
        * tl["scale"] * sign
    layers = list(params["layers"])
    last = dict(layers[-1])
    wo = last["wo"]
    if is_quantized(wo):
        last["wo"] = _requant_like(dequantize_weight(wo) + delta, wo)
    else:
        last["wo"] = wo + delta.to(wo.dtype)
    layers[-1] = last
    out = dict(params)
    out["layers"] = layers
    return out


def stack_text_loras(tls: Sequence[Params]) -> Params:
    """Stack G text-encoder adapters: ``a [G,d,r]``, ``b [G,r,d]``,
    ``scales [G]`` (ranks zero-padded to the largest)."""
    if not tls:
        raise ValueError("stack_text_loras needs at least one adapter")
    tls = [{k: (dequantize_weight(v) if k in ("a", "b") else v)
            for k, v in p.items()} for p in tls]
    rank = max(p["a"].shape[-1] for p in tls)
    return {
        "a": torch.stack([_pad_rank(p["a"], 1, rank) for p in tls]),
        "b": torch.stack([_pad_rank(p["b"], 0, rank) for p in tls]),
        "scales": torch.stack([torch.as_tensor(p["scale"], dtype=torch.float32)
                               for p in tls]),
    }
