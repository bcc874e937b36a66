"""MMDiT diffusion backbone (SD3/Flux-style), PyTorch port.

Joint text-image attention transformer with adaLN timestep modulation
[Esser et al. 2024].  The parameter tree matches the JAX package's: the
per-layer weights are *stacked* into ``[n_layers, ...]`` leaves under
``params["layers"][stream]``, and :func:`mmdit_apply` walks the layer
index of those stacks with a Python loop where the JAX package scans.

Dtype rules follow JAX's promotion: the residual stream is in the
latents' dtype (f32), projections against bf16 weights compute in f32
(:func:`~repro_torch.nn.layers.qdense`), and the casts back to
``x.dtype`` sit where the JAX package casts.

With ``lora_stack``/``lora_idx``, the image-stream q/k/v/o projections
run the grouped multi-adapter form (:func:`_lora_proj`).  Under
``REPRO_QUANT`` the stream projections are quantized dicts
(:func:`quantize_mmdit_params`) and take the quantized route of
:func:`~repro_torch.nn.layers.qdense`.

The ControlNet branch (:func:`init_controlnet`, :func:`controlnet_apply`)
is a truncated stack of the same blocks whose per-layer residuals feed
:func:`mmdit_apply`'s ``control_residuals``.

:func:`mmdit_apply_seq_sharded` is the sequence-sharded forward over the
slots of a :class:`~repro_torch.core.mesh.Submesh`: where the JAX package
runs one SPMD body per device, the port walks the layers once and, in
each, every shard in turn.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.diffusion.config import DiTConfig
from repro_torch.nn.layers import (
    dense_init,
    flash_attention_enabled,
    gelu,
    gqa_attention,
    grouped_lora_dense,
    modulate,
    qdense,
    quantize_dense,
    rms_norm,
    timestep_embedding,
)

Params = Dict[str, Any]


# ------------------------------------------------------------------ blocks

def _stacked_dense(gen: torch.Generator, n: int, d_in: int, d_out: int,
                   dtype: torch.dtype, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """``n`` layers of :func:`dense_init` weights as one ``[n, d_in, d_out]``
    leaf (one draw on the generator's device, scaled in f32, then cast)."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((n, d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def _init_stream(gen: torch.Generator, cfg: DiTConfig, n: int) -> Params:
    d, dff, dt, dev = cfg.d_model, cfg.d_ff, cfg.dtype, gen.device
    return {
        "ada": _stacked_dense(gen, n, d, 6 * d, dt, scale=0.02),
        "ada_b": torch.zeros((n, 6 * d), dtype=dt, device=dev),
        "norm1": torch.ones((n, d), dtype=dt, device=dev),
        "wq": _stacked_dense(gen, n, d, d, dt),
        "wk": _stacked_dense(gen, n, d, d, dt),
        "wv": _stacked_dense(gen, n, d, d, dt),
        "wo": _stacked_dense(gen, n, d, d, dt),
        "norm2": torch.ones((n, d), dtype=dt, device=dev),
        "w1": _stacked_dense(gen, n, d, dff, dt),
        "w2": _stacked_dense(gen, n, dff, d, dt),
    }


def init_layer(gen: torch.Generator, cfg: DiTConfig, n: int = 1) -> Params:
    """``n`` stacked MMDiT layers: ``{"img": ..., "txt": ...}`` with
    ``[n, ...]`` leaves."""
    return {"img": _init_stream(gen, cfg, n), "txt": _init_stream(gen, cfg, n)}


def _lora_proj(h: torch.Tensor, w: torch.Tensor, lora, target: str
               ) -> torch.Tensor:
    """``h @ w``, or the grouped per-row multi-LoRA projection when this
    layer carries adapter stacks for ``target``.  ``lora`` is
    ``(layer_stacks, idx, scales)`` with ``layer_stacks[f"{target}_a"]``
    ``[G, d, r]`` / ``..._b`` ``[G, r, d]``."""
    if lora is None:
        return qdense(h, w)
    stacks, idx, scales = lora
    return grouped_lora_dense(h, w, stacks[f"{target}_a"],
                              stacks[f"{target}_b"], idx, scales)


def _stream_qkv(p: Params, x: torch.Tensor, t_emb: torch.Tensor,
                n_heads: int, lora=None):
    ada = qdense(F.silu(t_emb), p["ada"]) + p["ada_b"]
    (s1, g1, m1, s2, g2, m2) = torch.chunk(ada, 6, dim=-1)
    m1 = 1.0 + m1          # gate baseline: identity-plus-delta
    m2 = 1.0 + m2
    h = modulate(rms_norm(x, p["norm1"]), s1, g1).to(x.dtype)
    b, s, d = h.shape
    hd = d // n_heads
    q = _lora_proj(h, p["wq"], lora, "wq").reshape(b, s, n_heads, hd)
    k = _lora_proj(h, p["wk"], lora, "wk").reshape(b, s, n_heads, hd)
    v = _lora_proj(h, p["wv"], lora, "wv").reshape(b, s, n_heads, hd)
    return q, k, v, (m1, s2, g2, m2)


def _stream_post(p: Params, x: torch.Tensor, attn_out: torch.Tensor, mods,
                 n_heads: int, lora=None) -> torch.Tensor:
    m1, s2, g2, m2 = mods
    b, s, _, _ = attn_out.shape
    # keep the residual stream in its own dtype (t_emb gates are f32)
    proj = _lora_proj(attn_out.reshape(b, s, -1), p["wo"], lora, "wo")
    x = x + (m1[:, None, :] * proj).to(x.dtype)
    h = modulate(rms_norm(x, p["norm2"]), s2, g2).to(x.dtype)
    x = x + (m2[:, None, :] * qdense(gelu(qdense(h, p["w1"])),
                                     p["w2"])).to(x.dtype)
    return x


def mmdit_block(
    p: Params,
    x: torch.Tensor,         # image tokens [B, Ti, d]
    c: torch.Tensor,         # text tokens  [B, Tc, d]
    t_emb: torch.Tensor,     # [B, d]
    n_heads: int,
    lora=None,               # (layer adapter stacks, idx [B], scales [G])
) -> Tuple[torch.Tensor, torch.Tensor]:
    qi, ki, vi, mods_i = _stream_qkv(p["img"], x, t_emb, n_heads, lora=lora)
    qt, kt, vt, mods_t = _stream_qkv(p["txt"], c, t_emb, n_heads)
    q = torch.cat([qt, qi], dim=1)
    k = torch.cat([kt, ki], dim=1)
    v = torch.cat([vt, vi], dim=1)
    out = gqa_attention(q, k, v, causal=False)
    tc = c.shape[1]
    out_t, out_i = out[:, :tc], out[:, tc:]
    x = _stream_post(p["img"], x, out_i, mods_i, n_heads, lora=lora)
    c = _stream_post(p["txt"], c, out_t, mods_t, n_heads)
    return x, c


# ------------------------------------------------------------ quantization

# the per-layer stream projections carry almost all backbone parameters;
# the embeddings and the final head stay as they are (small, I/O-critical)
_QUANT_STREAM_KEYS = ("ada", "wq", "wk", "wv", "wo", "w1", "w2")


def quantize_mmdit_params(params: Params) -> Params:
    """The layer-stacked stream projection weights quantized per the active
    ``REPRO_QUANT`` mode (the identity when off), in a copied tree: each
    ``[L, K, N]`` leaf becomes a ``{"qw": [L, K, N], "qs": [L, 1, N]}``
    dict that the layer loop slices like the tensor it replaces."""
    layers = {stream: {k: (quantize_dense(v) if k in _QUANT_STREAM_KEYS
                           else v) for k, v in sp.items()}
              for stream, sp in params["layers"].items()}
    return {**params, "layers": layers}


# ---------------------------------------------------------------- backbone

def init_mmdit(gen: torch.Generator, cfg: DiTConfig) -> Params:
    """Backbone parameters drawn on the generator's device."""
    d, dt, dev = cfg.d_model, cfg.dtype, gen.device
    in_dim = cfg.patch * cfg.patch * cfg.latent_channels
    return {
        "patch_embed": dense_init(gen, in_dim, d, dt),
        "text_proj": dense_init(gen, cfg.text_dim, d, dt),
        "t_mlp1": dense_init(gen, 256, d, dt),
        "t_mlp2": dense_init(gen, d, d, dt),
        "layers": init_layer(gen, cfg, cfg.n_layers),
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "final_ada": dense_init(gen, d, 2 * d, dt, scale=0.02),
        "final_ada_b": torch.zeros((2 * d,), dtype=dt, device=dev),
        "final_proj": dense_init(gen, d, in_dim, dt),
    }


def patchify(latents: torch.Tensor, patch: int) -> torch.Tensor:
    b, h, w, ch = latents.shape
    x = latents.reshape(b, h // patch, patch, w // patch, patch, ch)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * ch)


def unpatchify(tokens: torch.Tensor, patch: int, size: int,
               channels: int) -> torch.Tensor:
    b = tokens.shape[0]
    g = size // patch
    x = tokens.reshape(b, g, g, patch, patch, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, size, size, channels)


def _embed_inputs(params: Params, cfg: DiTConfig, latents, t, text_emb):
    x = qdense(patchify(latents, cfg.patch), params["patch_embed"])
    c = qdense(text_emb, params["text_proj"])
    t_emb = timestep_embedding(t, 256)
    t_emb = qdense(F.silu(qdense(t_emb, params["t_mlp1"])), params["t_mlp2"])
    return x, c, t_emb


def _layer(layers: Params, i: int) -> Params:
    """Layer ``i`` of the stacked per-layer tree (views, no copies).  A
    quantized leaf is sliced leaf by leaf: ``qw [L, K, N]`` and
    ``qs [L, 1, N]`` give layer ``i``'s ``[K, N]`` and ``[1, N]``, as the
    JAX package's layer scan slices its ``xs``."""
    return {stream: {k: ({q: t[i] for q, t in v.items()}
                         if isinstance(v, dict) else v[i])
                     for k, v in sp.items()}
            for stream, sp in layers.items()}


def mmdit_apply(
    params: Params,
    cfg: DiTConfig,
    latents: torch.Tensor,                    # [B, S, S, C]
    t: torch.Tensor,                          # [B]
    text_emb: torch.Tensor,                   # [B, Tc, text_dim]
    control_residuals: Optional[torch.Tensor] = None,   # [L, B, Ti, d]
    lora_stack: Optional[Params] = None,      # stack_loras output ([L,G,...])
    lora_idx: Optional[torch.Tensor] = None,  # [B] int32; -1 = no adapter
) -> torch.Tensor:
    """One denoising forward pass; returns the velocity prediction.

    When ``lora_stack``/``lora_idx`` are given, the image-stream attention
    projections run the grouped multi-adapter form: each batch row applies
    its own LoRA (``lora_idx[b]``) against the shared base weights.  Layer
    ``i`` of the loop takes layer ``i`` of each ``[L, G, ...]`` stack, as
    the JAX package's layer scan takes it from its ``xs``.

    Absent ControlNet residuals are skipped, not materialized: the JAX
    package adds an all-zero ``[L, B, Ti, d]`` stack (about 1.2 GB per
    CFG-doubled request at full SD3 width in f32), and adding an exact
    zero changes no bit apart from the sign of a -0.0."""
    x, c, t_emb = _embed_inputs(params, cfg, latents, t, text_emb)
    lora = None
    idx = None if lora_idx is None else lora_idx.to(torch.int32)
    for i in range(cfg.n_layers):
        if lora_stack is not None:
            lora = ({k: v[i] for k, v in lora_stack.items() if k != "scales"},
                    idx, lora_stack["scales"])
        x, c = mmdit_block(_layer(params["layers"], i), x, c, t_emb,
                           cfg.n_heads, lora=lora)
        if control_residuals is not None:
            x = x + control_residuals[i]
    ada = qdense(F.silu(t_emb), params["final_ada"]) + params["final_ada_b"]
    shift, scale = torch.chunk(ada, 2, dim=-1)
    x = modulate(rms_norm(x, params["final_norm"]), shift, scale)
    out = qdense(x, params["final_proj"])
    return unpatchify(out, cfg.patch, cfg.latent_size, cfg.latent_channels)


# ------------------------------------------------- sequence-sharded backbone

def _mmdit_block_seq(
    ps: List[Params],             # layer params, one tree per slot
    xs: List[torch.Tensor],       # LOCAL image tokens [B, Ti/k, d] per slot
    cs: List[torch.Tensor],       # text tokens [B, Tc, d], one copy per slot
    t_embs: List[torch.Tensor],   # [B, d] per slot
    n_heads: int,
    mesh: Any,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One MMDiT block under sequence sharding: each slot holds a
    contiguous slice of the image tokens.  Every shard's q/k/v first, then
    one all-gather of the image K/V keeps joint attention exact, then each
    shard's local queries (text plus its image slice) attend over every key
    through the same flash-attention route as the unsharded block (the
    kernel takes the rectangular local-q x global-kv shape), and its post.
    Each slot's text stream sees only its own copies and gathered operands,
    as in the JAX package, which keeps it replicated without a second
    collective."""
    img = [_stream_qkv(p["img"], x, te, n_heads)
           for p, x, te in zip(ps, xs, t_embs)]
    txt = [_stream_qkv(p["txt"], c, te, n_heads)
           for p, c, te in zip(ps, cs, t_embs)]
    kis = mesh.all_gather([s[1] for s in img], dim=1)
    vis = mesh.all_gather([s[2] for s in img], dim=1)
    out_x, out_c = [], []
    for p, x, c, (qi, _, _, mods_i), (qt, kt, vt, mods_t), ki, vi in zip(
            ps, xs, cs, img, txt, kis, vis):
        q = torch.cat([qt, qi], dim=1)        # [B, Tc + Ti/k, H, hd]
        k = torch.cat([kt, ki], dim=1)        # [B, Tc + Ti,   H, hd]
        v = torch.cat([vt, vi], dim=1)
        if flash_attention_enabled():
            from repro_torch.kernels.flash_attention.ops import mha

            out = mha(q, k, v, causal=False)
        else:
            out = gqa_attention(q, k, v, causal=False)
        tc = c.shape[1]
        out_x.append(_stream_post(p["img"], x, out[:, tc:], mods_i, n_heads))
        out_c.append(_stream_post(p["txt"], c, out[:, :tc], mods_t, n_heads))
    return out_x, out_c


def seq_shard_divisor(cfg: DiTConfig, k: int) -> bool:
    """Can the latent's patch-row grid split evenly across k devices?"""
    return (cfg.latent_size // cfg.patch) % k == 0


def mmdit_apply_seq_sharded(
    params: Any,                              # one tree, or one per slot
    cfg: DiTConfig,
    latents: torch.Tensor,                    # [B, S, S, C]
    t: torch.Tensor,                          # [B]
    text_emb: torch.Tensor,                   # [B, Tc, text_dim]
    control_residuals: Optional[torch.Tensor],   # [L, B, Ti, d]
    mesh: Any,
) -> torch.Tensor:
    """Sequence-sharded denoising forward over a submesh's slots (§5.2).

    The latent's spatial rows (equivalently, contiguous image-token chunks:
    patchify is row-major over the patch grid) split across the slots;
    parameters, timesteps and text embeddings are on every slot, and each
    slot takes its token slice of the residuals.  Per layer the image K/V
    are all-gathered, so attention is exact; everything else is
    token-local.  Composes with batches of ANY size: the path adaptive
    parallelism needs when a batch has fewer rows than the submesh has
    slots (one CFG pair on k = 4).  Returns the velocity gathered on the
    home slot.  Absent residuals are skipped, as in :func:`mmdit_apply`."""
    replicas = (list(params) if isinstance(params, (list, tuple))
                else mesh.replicate(params))
    # same embedding as the unsharded forward; patchify sees only this
    # shard's latent rows, so x holds the local token slice
    embedded = [_embed_inputs(p, cfg, lat, tt, emb) for p, lat, tt, emb in zip(
        replicas, mesh.scatter(latents, dim=1), mesh.replicate(t),
        mesh.replicate(text_emb))]
    xs, cs, t_embs = (list(z) for z in zip(*embedded))
    res = (None if control_residuals is None
           else mesh.scatter(control_residuals, dim=2))
    for i in range(cfg.n_layers):
        xs, cs = _mmdit_block_seq([_layer(p["layers"], i) for p in replicas],
                                  xs, cs, t_embs, cfg.n_heads, mesh)
        if res is not None:
            xs = [x + r[i] for x, r in zip(xs, res)]
    g = cfg.latent_size // cfg.patch              # global patch columns
    outs = []
    for p, x, te in zip(replicas, xs, t_embs):
        ada = qdense(F.silu(te), p["final_ada"]) + p["final_ada_b"]
        shift, scale = torch.chunk(ada, 2, dim=-1)
        x = modulate(rms_norm(x, p["final_norm"]), shift, scale)
        out = qdense(x, p["final_proj"])
        # local unpatchify: this shard's token rows -> its latent rows
        b, rows = out.shape[0], out.shape[1] // g
        o = out.reshape(b, rows, g, cfg.patch, cfg.patch, cfg.latent_channels)
        outs.append(o.permute(0, 1, 3, 2, 4, 5).reshape(
            b, rows * cfg.patch, cfg.latent_size, cfg.latent_channels))
    return mesh.gather(outs, dim=1)


# -------------------------------------------------------------- ControlNet

def init_controlnet(gen: torch.Generator, cfg: DiTConfig,
                    n_cn_layers: Optional[int] = None) -> Params:
    """ControlNet branch drawn on the generator's device: the JAX package's
    tree leaf for leaf (the backbone's embeddings, a zero ``cond_embed``,
    ``n_cn`` stacked layers and small ``[n_cn, d, d]`` residual
    projections).  The JAX package draws a whole backbone to keep its four
    embeddings; this draws only what it keeps (a torch generator never
    gives JAX's draws anyway)."""
    n_cn = n_cn_layers or max(1, cfg.n_layers // 2)
    d, dt = cfg.d_model, cfg.dtype
    in_dim = cfg.patch * cfg.patch * cfg.latent_channels
    return {
        "patch_embed": dense_init(gen, in_dim, d, dt),
        "cond_embed": dense_init(gen, in_dim, d, dt, scale=0.0),
        "text_proj": dense_init(gen, cfg.text_dim, d, dt),
        "t_mlp1": dense_init(gen, 256, d, dt),
        "t_mlp2": dense_init(gen, d, d, dt),
        "layers": init_layer(gen, cfg, n_cn),
        # small (not zero) residual projections so the executable plane is
        # non-degenerate; true zero-init is a training-time concern
        "zero_proj": _stacked_dense(gen, n_cn, d, d, dt, scale=0.02),
    }


def controlnet_apply(
    params: Params,
    cfg: DiTConfig,
    latents: torch.Tensor,        # current noisy latents [B, S, S, C]
    cond_latents: torch.Tensor,   # VAE-encoded reference image [B, S, S, C]
    t: torch.Tensor,              # [B]
    text_emb: torch.Tensor,       # [B, Tc, text_dim]
) -> torch.Tensor:
    """Returns residuals ``[n_layers, B, Ti, d]``, zero-padded to the
    backbone's full depth as in the JAX package: layer ``i < n_cn`` holds
    ``x_i @ zero_proj[i]``, the deeper layers zeros.  The stack is written
    in place, so no per-layer copy and no concatenation is made."""
    x, c, t_emb = _embed_inputs(params, cfg, latents, t, text_emb)
    x = x + qdense(patchify(cond_latents, cfg.patch), params["cond_embed"])
    out = None
    for i in range(params["zero_proj"].shape[0]):
        x, c = mmdit_block(_layer(params["layers"], i), x, c, t_emb,
                           cfg.n_heads)
        r = qdense(x, params["zero_proj"][i])
        if out is None:
            out = r.new_zeros((cfg.n_layers,) + tuple(r.shape))
        out[i] = r
    return out
