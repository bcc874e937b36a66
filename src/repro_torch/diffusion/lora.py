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

The JAX package also quantizes factors on fold (``quantize_lora``,
``quantize_text_lora``, ``_requant_like``) under ``REPRO_QUANT``.  The
port's ``quant_mode()`` is always ``"off"`` until the quant slice, and with
it off those steps are the identity, so they are not here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from repro_torch.diffusion.config import DiTConfig

Params = Dict[str, Any]

TARGETS = ("wq", "wk", "wv", "wo")


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
    weights the folded weight is ``W + ΔW`` rounded to bf16."""
    scale = lora["scale"]
    new_layers = dict(params["layers"])
    new_img = dict(new_layers["img"])
    for t in TARGETS:
        delta = torch.einsum("ldr,lre->lde", lora[f"{t}_a"],
                             lora[f"{t}_b"]) * scale
        base = new_layers["img"][t]
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
    ``wo`` (functional)."""
    delta = (tl["a"] @ tl["b"]) * tl["scale"] * sign
    layers = list(params["layers"])
    last = dict(layers[-1])
    last["wo"] = last["wo"] + delta.to(last["wo"].dtype)
    layers[-1] = last
    out = dict(params)
    out["layers"] = layers
    return out


def stack_text_loras(tls: Sequence[Params]) -> Params:
    """Stack G text-encoder adapters: ``a [G,d,r]``, ``b [G,r,d]``,
    ``scales [G]`` (ranks zero-padded to the largest)."""
    if not tls:
        raise ValueError("stack_text_loras needs at least one adapter")
    rank = max(p["a"].shape[-1] for p in tls)
    return {
        "a": torch.stack([_pad_rank(p["a"], 1, rank) for p in tls]),
        "b": torch.stack([_pad_rank(p["b"], 0, rank) for p in tls]),
        "scales": torch.stack([torch.as_tensor(p["scale"], dtype=torch.float32)
                               for p in tls]),
    }
