"""Text encoder and VAE decoder for the executable diffusion workflows.

* :func:`init_text_encoder` / :func:`text_encoder_apply` — a small
  bidirectional transformer standing in for CLIP/T5 (real-scale costs are
  carried by the profiles, not by this stand-in's size);
* :func:`init_vae` / :func:`vae_encode` / :func:`vae_decode` — the
  convolutional encoder mapping pixels to the 8x-downsampled latent space
  (the ControlNet conditioning) and the decoder mapping latents back to
  pixels.  Images and latents are NHWC, conv weights HWIO, as in the JAX
  package.
"""

from __future__ import annotations

import math
import zlib
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import (
    dense_init,
    embed_init,
    gelu_mlp,
    gqa_attention,
    grouped_lora_dense,
    init_mlp,
    qdense,
    quantize_dense,
    rms_norm,
)

Params = Dict[str, Any]


def stable_hash(s: str) -> int:
    """Process-stable string hash for RNG seeding and toy tokenization.

    Python's builtin ``hash`` is salted by ``PYTHONHASHSEED``, so two
    executor processes loading the same ``model_id`` would initialize
    different weights.  CRC32 is deterministic everywhere.
    """
    return zlib.crc32(s.encode("utf-8"))


# ------------------------------------------------------------ text encoder

def init_text_encoder(
    gen: torch.Generator, vocab: int, d_model: int, n_layers: int,
    n_heads: int, max_len: int = 77, dtype: torch.dtype = torch.float32,
) -> Params:
    """Parameters drawn on the generator's device."""
    dev = gen.device
    tok = embed_init(gen, vocab, d_model, dtype)
    pos = embed_init(gen, max_len, d_model, dtype)
    layers = []
    for _ in range(n_layers):
        layers.append({
            "norm1": torch.ones((d_model,), dtype=dtype, device=dev),
            "wq": dense_init(gen, d_model, d_model, dtype),
            "wk": dense_init(gen, d_model, d_model, dtype),
            "wv": dense_init(gen, d_model, d_model, dtype),
            "wo": dense_init(gen, d_model, d_model, dtype),
            "norm2": torch.ones((d_model,), dtype=dtype, device=dev),
            "mlp": init_mlp(gen, d_model, 4 * d_model, dtype),
        })
    return {
        "tok": tok,
        "pos": pos,
        "layers": layers,
        "final": torch.ones((d_model,), dtype=dtype, device=dev),
    }


# the attention and MLP projections carry nearly all encoder parameters;
# the embeddings and norms stay as they are
_QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo")


def quantize_text_params(params: Params) -> Params:
    """The per-layer projection weights (``wq``/``wk``/``wv``/``wo`` and the
    MLP's ``w1``/``w2``) quantized per the active ``REPRO_QUANT`` mode (the
    identity when off), in a copied tree."""
    layers = []
    for p in params["layers"]:
        layer = {k: (quantize_dense(v) if k in _QUANT_LAYER_KEYS else v)
                 for k, v in p.items()}
        layer["mlp"] = {k: (quantize_dense(v) if k in ("w1", "w2") else v)
                        for k, v in p["mlp"].items()}
        layers.append(layer)
    return {**params, "layers": layers}


def text_encoder_apply(params: Params, token_ids: torch.Tensor,
                       n_heads: int, lora_stack: Optional[Params] = None,
                       lora_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """token_ids [B, S] -> embeddings [B, S, d].

    ``lora_stack`` (from :func:`repro_torch.diffusion.lora.stack_text_loras`)
    plus a per-row ``lora_idx`` [B] run the grouped multi-adapter form of
    the LAST layer's output projection; rows with ``idx < 0`` stay plain.
    """
    b, s = token_ids.shape
    x = params["tok"][token_ids] + params["pos"][None, :s]
    n_layers = len(params["layers"])
    for li, p in enumerate(params["layers"]):
        h = rms_norm(x, p["norm1"])
        bb, ss, d = h.shape
        hd = d // n_heads
        q = qdense(h, p["wq"]).reshape(bb, ss, n_heads, hd)
        k = qdense(h, p["wk"]).reshape(bb, ss, n_heads, hd)
        v = qdense(h, p["wv"]).reshape(bb, ss, n_heads, hd)
        attn = gqa_attention(q, k, v, causal=False).reshape(bb, ss, d)
        if lora_stack is not None and li == n_layers - 1:
            x = x + grouped_lora_dense(
                attn, p["wo"], lora_stack["a"], lora_stack["b"],
                lora_idx.to(torch.int32), lora_stack["scales"])
        else:
            x = x + qdense(attn, p["wo"])
        x = x + gelu_mlp(p["mlp"], rms_norm(x, p["norm2"]))
    return rms_norm(x, params["final"])


def _token_ids(prompt: str, vocab: int, max_len: int) -> list:
    ids = [stable_hash(w) % (vocab - 2) + 2
           for w in prompt.lower().split()][: max_len - 1]
    ids = [1] + ids
    return ids + [0] * (max_len - len(ids))


def tokenize(prompt: str, vocab: int, max_len: int,
             device: Any = "cpu") -> torch.Tensor:
    """Deterministic toy tokenizer: CRC-hash words into the vocab (stable
    across processes regardless of ``PYTHONHASHSEED``)."""
    return tokenize_batch([prompt], vocab, max_len, device)


def tokenize_batch(prompts: Sequence[str], vocab: int, max_len: int,
                   device: Any = "cpu") -> torch.Tensor:
    """Tokenize a batch of prompts into one [B, max_len] id matrix (one
    host->device transfer, not one per prompt)."""
    return torch.tensor([_token_ids(p, vocab, max_len) for p in prompts],
                        dtype=torch.long, device=device)


# -------------------------------------------------------------------- VAE

def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
               dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(kh * kw * cin)
    w = torch.randn((kh, kw, cin, cout), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.to(dtype) * scale


def init_vae(gen: torch.Generator, image_channels: int = 3,
             latent_channels: int = 4, base: int = 32,
             dtype: torch.dtype = torch.float32) -> Params:
    """Three stride-2 stages: pixels (S*8, S*8) <-> latents (S, S).  The
    tree matches the JAX package's one-for-one: the encoder half
    (``enc``, ``enc_out``) and the decoder half (``dec_in``, ``dec``)."""
    return {
        "enc": [
            _conv_init(gen, 3, 3, image_channels, base, dtype),
            _conv_init(gen, 3, 3, base, base * 2, dtype),
            _conv_init(gen, 3, 3, base * 2, base * 2, dtype),
        ],
        "enc_out": _conv_init(gen, 1, 1, base * 2, latent_channels, dtype),
        "dec_in": _conv_init(gen, 1, 1, latent_channels, base * 2, dtype),
        "dec": [
            _conv_init(gen, 3, 3, base * 2, base * 2, dtype),
            _conv_init(gen, 3, 3, base * 2, base, dtype),
            _conv_init(gen, 3, 3, base, image_channels, dtype),
        ],
    }


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 ``"SAME"`` conv of an NCHW tensor with an HWIO weight.  At
    stride 1 with odd kernels, XLA's SAME padding is symmetric, which is
    what torch's ``padding="same"`` does."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), padding="same")


def _conv_strided(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Strided ``"SAME"`` conv of an NCHW tensor with an HWIO weight, padded
    as XLA pads: ``ceil(n / stride)`` outputs, the padding's odd element
    after the input.  A 3x3 kernel at stride 2 on an even input pads
    (0, 1), where torch's ``padding=1`` would pad (1, 1) and shift every
    output by one input pixel."""
    pads = []
    for n, k in ((x.shape[3], w.shape[1]), (x.shape[2], w.shape[0])):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w.permute(3, 2, 0, 1), stride=stride)


def vae_encode(params: Params, image: torch.Tensor) -> torch.Tensor:
    """image [B, H, W, 3] -> latents [B, H/8, W/8, C]."""
    x = image.permute(0, 3, 1, 2)
    for w in params["enc"]:
        x = F.silu(_conv_strided(x, w, 2))
    return _conv(x, params["enc_out"]).permute(0, 2, 3, 1).contiguous()


def vae_decode(params: Params, latents: torch.Tensor) -> torch.Tensor:
    """latents [B, S, S, C] -> image [B, 8S, 8S, 3] in [-1, 1]."""
    x = _conv(latents.permute(0, 3, 1, 2), params["dec_in"])
    for i, w in enumerate(params["dec"]):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        x = _conv(x, w)
        if i < len(params["dec"]) - 1:
            x = F.silu(x)
    return torch.tanh(x).permute(0, 2, 3, 1).contiguous()
