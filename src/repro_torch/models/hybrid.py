"""RecurrentGemma / Griffin hybrid stack: RG-LRU blocks + local attention.

[arXiv:2402.19427]  The pattern is (recurrent, recurrent, local-attention)
repeating, "1:2".  Each residual block is ``norm -> temporal mixing ->
residual; norm -> gated MLP -> residual``.

The RG-LRU temporal mixer:

    r_t = sigmoid(W_r x_t)            (recurrence gate)
    i_t = sigmoid(W_i x_t)            (input gate)
    a_t = exp(-c * softplus(L) * r_t) (decay, elementwise)
    h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * u_t)

with a width-4 causal conv in front (Griffin).  The scan over time runs
through :func:`repro_torch.kernels.rglru_scan.ops.rglru`: the CUDA
``rglru_scan`` kernel for a CUDA tensor, its plain version (the JAX
package's associative-scan oracle) for a CPU one.  A forward launches it
once per RG-LRU block: 18 times for recurrentgemma-2b's 26 layers (8
super-blocks of two, plus 2 remainder blocks).  A training step under
``remat=True`` (the JAX package's ``jax.checkpoint`` around each
super-block; the remainder blocks are not rematerialised) launches the
forward again for each super-block's two scans in the backward, and the
scan's backward kernel once per block.

Local attention uses GQA with ``n_kv_heads=1`` (MQA) and a sliding window,
so the whole architecture is O(seq).  Parameters keep the JAX package's
layout: super-block leaves ``[n_super, 2 | 1, ...]``, remainder leaves
``[rem, ...]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru
from repro_torch.models import transformer as tfm
from repro_torch.models.act_sharding import constrain
from repro_torch.models.base import ArchConfig
from repro_torch.nn.layers import (
    embed_init,
    gelu,
    mask_vocab,
    rms_norm,
    rope_frequencies,
)

Params = Dict[str, Any]

PATTERN = ("r", "r", "a")
CONV_WIDTH = 4
LOCAL_WINDOW = 2048
RGLRU_C = 8.0


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_rglru_blocks(gen: torch.Generator, cfg: ArchConfig, lead,
                       dtype: torch.dtype, device: Any) -> Params:
    d, lead = cfg.d_model, tuple(lead)

    def dense(d_in, d_out):
        return tfm.stacked_dense(gen, lead, d_in, d_out, dtype, device)

    conv = torch.randn((*lead, CONV_WIDTH, d), generator=gen, device=device,
                       dtype=torch.float32)
    return {
        "norm1": torch.ones((*lead, d), dtype=dtype, device=device),
        "w_in": dense(d, d),
        "w_gate_branch": dense(d, d),
        "conv": conv.mul_(0.1).to(dtype),
        "w_r": dense(d, d),
        "w_i": dense(d, d),
        "lam": torch.full((*lead, d), 0.5, dtype=dtype, device=device),
        "w_out": dense(d, d),
        "norm2": torch.ones((*lead, d), dtype=dtype, device=device),
        "mlp_gate": dense(d, cfg.d_ff),
        "mlp_up": dense(d, cfg.d_ff),
        "mlp_down": dense(cfg.d_ff, d),
    }


def _attn_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, arch_type="dense",
                               sliding_window=LOCAL_WINDOW)


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype: torch.dtype = torch.float32, device: Any = "cuda"
                ) -> Params:
    n_super, rem = divmod(cfg.n_layers, len(PATTERN))
    p: Params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": tfm.stacked_dense(gen, (), cfg.d_model, cfg.padded_vocab,
                                     dtype, device),
    }
    if n_super:
        p["rglru"] = _init_rglru_blocks(gen, cfg, (n_super, 2), dtype, device)
        p["attn"] = tfm.init_blocks(gen, _attn_cfg(cfg), (n_super, 1), dtype,
                                    device)
    if rem:
        p["rem_rglru"] = _init_rglru_blocks(gen, cfg, (rem,), dtype, device)
    return p


# --------------------------------------------------------------------------
# RG-LRU block
# --------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width 4.  ``tail``: [B, W-1, d] carry-in."""
    b, s, d = x.shape
    if tail is None:
        tail = torch.zeros((b, CONV_WIDTH - 1, d), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i: i + s] * w[i] for i in range(CONV_WIDTH))
    return out, xp[:, -(CONV_WIDTH - 1):]


def _gates(p: Params, xn: torch.Tensor):
    """The input gate i and the decay a, in f32: each sigmoid is computed
    in the parameters' dtype first, as the JAX package does."""
    r = torch.sigmoid(xn @ p["w_r"]).float()
    i = torch.sigmoid(xn @ p["w_i"]).float()
    return i, torch.exp(-RGLRU_C * F.softplus(p["lam"].float()) * r)


def _gated_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    xn2 = rms_norm(x, p["norm2"])
    y = (gelu(xn2 @ p["mlp_gate"]) * (xn2 @ p["mlp_up"])) @ p["mlp_down"]
    return x + y


def rglru_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
    xn = rms_norm(x, p["norm1"])
    u = xn @ p["w_in"]
    gate = gelu(xn @ p["w_gate_branch"])
    tail = state[1] if state is not None else None
    u, new_tail = _causal_conv(u, p["conv"], tail)
    i, a = _gates(p, xn)
    xin = i * u.float()
    if state is not None and state[0] is not None:
        # carry-in: h_0 enters as an extra decayed contribution on step 1
        xin[:, 0] += (a[:, 0] * state[0]
                      / torch.sqrt(torch.clamp(1 - a[:, 0] ** 2, min=1e-6)))
    h = rglru(a, xin)                   # the kernel on the card
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return _gated_mlp(p, x + out), (h[:, -1], new_tail)


def rglru_block_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                       state: Tuple) -> Tuple[torch.Tensor, Tuple]:
    """x: [B,1,d]; state = (h [B,d] fp32, conv tail [B,3,d])."""
    h_prev, tail = state
    xn = rms_norm(x, p["norm1"])
    u = xn @ p["w_in"]
    gate = gelu(xn @ p["w_gate_branch"])
    xp = torch.cat([tail, u], dim=1)                      # [B, W, d]
    u1 = torch.einsum("bwd,wd->bd", xp, p["conv"].to(xp.dtype))
    i, a = _gates(p, xn)
    a, i = a[:, 0], i[:, 0]
    h = a * h_prev + torch.sqrt(torch.clamp(1 - a * a, min=0.0)) * (
        i * u1.float())
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return _gated_mlp(p, x + out), (h, xp[:, 1:])


# --------------------------------------------------------------------------
# full stack
# --------------------------------------------------------------------------

def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            remat: bool = True, last_only: bool = False, **_: Any
            ) -> torch.Tensor:
    # F.embedding: a backward that repeats bit for bit (transformer.forward)
    x = F.embedding(tokens, params["embed"]).to(params["lm_head"].dtype)
    acfg = _attn_cfg(cfg)
    rope = rope_frequencies(cfg.head_dim, tokens.shape[1], cfg.rope_theta,
                            device=x.device)
    n_super, rem = divmod(cfg.n_layers, len(PATTERN))

    def super_body(rp, ap, x):
        for j in range(2):
            x, _ = rglru_block(tfm.layer(rp, j), x, cfg)
        return constrain(tfm.block_apply(tfm.layer(ap, 0), x, acfg, rope,
                                         causal=True, window=LOCAL_WINDOW))

    x = constrain(x)
    for si in range(n_super):
        x = tfm.remat_apply(super_body, remat, tfm.layer(params["rglru"], si),
                            tfm.layer(params["attn"], si), x)
    for ri in range(rem):
        x, _ = rglru_block(tfm.layer(params["rem_rglru"], ri), x, cfg)
    x = rms_norm(x, params["final_norm"])
    if last_only:
        x = x[:, -1:]
    return mask_vocab(x @ params["lm_head"], cfg.vocab)


def init_decode_cache(cfg: ArchConfig, batch: int, seq_len: int,
                      dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
                      **_: Any) -> Dict[str, Any]:
    n_super, rem = divmod(cfg.n_layers, len(PATTERN))
    d = cfg.d_model
    win = min(LOCAL_WINDOW, seq_len)
    kv = (n_super, 1, batch, win, cfg.n_kv_heads, cfg.head_dim)
    cache: Dict[str, Any] = {
        "h": torch.zeros((n_super, 2, batch, d), dtype=torch.float32,
                         device=device),
        "tail": torch.zeros((n_super, 2, batch, CONV_WIDTH - 1, d),
                            dtype=dtype, device=device),
        "ak": torch.zeros(kv, dtype=dtype, device=device),
        "av": torch.zeros(kv, dtype=dtype, device=device),
        "pos": 0,
    }
    if rem:
        cache["h_rem"] = torch.zeros((rem, batch, d), dtype=torch.float32,
                                     device=device)
        cache["tail_rem"] = torch.zeros((rem, batch, CONV_WIDTH - 1, d),
                                        dtype=dtype, device=device)
    return cache


def decode_step(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                token: torch.Tensor, **_: Any
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token per row; writes the recurrent states, conv tails and ring
    caches in place.  A conv tail comes back in the dtype the JAX package's
    step gives it, ``concatenate([tail, u])``'s: a bf16 tail against f32
    activations is promoted on the first step, into a new tensor handed
    back in the returned dict (the caller's stays as it was), and written
    in place from the next step on."""
    x = params["embed"][token][:, None, :].to(params["lm_head"].dtype)
    acfg = _attn_cfg(cfg)
    pos = int(cache["pos"])
    win = cache["ak"].shape[3]
    rope = rope_frequencies(cfg.head_dim, win, cfg.rope_theta,
                            device=x.device)
    n_super, rem = divmod(cfg.n_layers, len(PATTERN))
    new = {**cache, "pos": pos + 1}

    def recur(p, x, h_key, tail_key, idx):
        x, (hj, tj) = rglru_block_decode(p, x, cfg, (new[h_key][idx],
                                                     new[tail_key][idx]))
        for key, value in ((h_key, hj), (tail_key, tj)):
            if new[key].dtype != value.dtype:
                new[key] = new[key].to(value.dtype)
            new[key][idx].copy_(value)
        return x

    for si in range(n_super):
        rp = tfm.layer(params["rglru"], si)
        for j in range(2):
            x = recur(tfm.layer(rp, j), x, "h", "tail", (si, j))
        a0 = tfm.layer(tfm.layer(params["attn"], si), 0)
        x = tfm._decode_attn_ring(a0, x, acfg, rope, pos, cache["ak"][si, 0],
                                  cache["av"][si, 0])
        x = tfm._mlp(a0, x, acfg)
    for ri in range(rem):
        x = recur(tfm.layer(params["rem_rglru"], ri), x, "h_rem", "tail_rem",
                  ri)
    x = rms_norm(x, params["final_norm"])
    logits = mask_vocab((x @ params["lm_head"])[:, 0], cfg.vocab)
    return logits, new
