"""Unified transformer stack: dense GQA, MoE, VLM backbone and enc-dec.

Covers llama3-8b, yi-34b, h2o-danube-3 (native SWA), qwen3 (qk-norm),
granite-moe (32 experts, top 8), grok-1 (8 experts, top 2), internvl2
(stub ViT frontend) and whisper-tiny (stub conv frontend,
encoder-decoder), as the JAX package's ``repro.models.transformer`` does.

* Layer-stacked leaves are ``[L, ...]`` and the layers run in a Python
  loop over ``L`` (the JAX package's ``lax.scan``).
* MoE uses sort-based capacity dispatch (a stable sort by expert id, then
  a scatter into ``[E, C, d]`` buffers and a gather back): its operations
  stay proportional to the activated parameters.  Ranks at or past the
  capacity are dropped explicitly, where JAX's ``mode="drop"`` and
  ``mode="fill"`` drop them silently.
* ``forward(remat=True)`` rematerialises each decoder layer in the
  backward (:func:`remat_apply`, the JAX package's ``jax.checkpoint``
  around its scan body) when grad is enabled; the encoder is not
  rematerialised, as in the JAX package.
* Decode supports a full KV cache and a ring-buffer sliding-window cache
  (the ``swa_decode_variant``), and, with ``act_sharding``'s
  ``decode_shards`` installed, the flash-decode over a sequence-sharded
  full cache (:func:`_flash_decode_shardmap`).  A decode step writes the
  cache tensors in place (the JAX package's launcher donates them) and
  returns the cache dict with ``pos`` advanced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.meta import on_labelled_shards, on_local_shards
from repro_torch.models import act_sharding
from repro_torch.models.act_sharding import constrain
from repro_torch.models.base import ArchConfig
from repro_torch.nn.layers import (
    apply_rope,
    embed_init,
    gqa_attention,
    mask_vocab,
    qdense,
    rms_norm,
    rope_frequencies,
    swiglu,
    update_slice_,
)

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def stacked_dense(gen: torch.Generator, lead: Sequence[int], d_in: int,
                  d_out: int, dtype: torch.dtype, device: Any) -> torch.Tensor:
    """``[*lead, d_in, d_out]`` normal draws scaled by ``1/sqrt(d_in)`` in
    f32, then cast: ``dense_init`` for a stack of layers in one draw."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def init_blocks(gen: torch.Generator, cfg: ArchConfig, lead: Sequence[int],
                dtype: torch.dtype, device: Any, cross: bool = False
                ) -> Params:
    """Parameters of ``lead`` stacked blocks (``lead = (L,)`` for a plain
    stack), each leaf ``[*lead, ...]``."""
    d, hd = cfg.d_model, cfg.head_dim
    lead = tuple(lead)

    def dense(d_in, d_out, *extra):
        return stacked_dense(gen, lead + extra, d_in, d_out, dtype, device)

    def ones(n):
        return torch.ones((*lead, n), dtype=dtype, device=device)

    p: Params = {
        "norm1": ones(d),
        "wq": dense(d, cfg.n_heads * hd),
        "wk": dense(d, cfg.n_kv_heads * hd),
        "wv": dense(d, cfg.n_kv_heads * hd),
        "wo": dense(cfg.n_heads * hd, d),
        "norm2": ones(d),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones(hd)
        p["k_norm"] = ones(hd)
    if cfg.arch_type == "moe":
        e = cfg.n_experts
        p["router"] = dense(d, e)
        p["moe_gate"] = stacked_dense(gen, lead + (e,), d, cfg.d_ff, dtype, device)
        p["moe_up"] = stacked_dense(gen, lead + (e,), d, cfg.d_ff, dtype, device)
        p["moe_down"] = stacked_dense(gen, lead + (e,), cfg.d_ff, d, dtype, device)
    else:
        p["mlp"] = {"w_gate": dense(d, cfg.d_ff), "w_up": dense(d, cfg.d_ff),
                    "w_down": dense(cfg.d_ff, d)}
    if cross:
        p["cross_norm"] = ones(d)
        p["cwq"] = dense(d, cfg.n_heads * hd)
        p["cwk"] = dense(d, cfg.n_kv_heads * hd)
        p["cwv"] = dense(d, cfg.n_kv_heads * hd)
        p["cwo"] = dense(cfg.n_heads * hd, d)
    return p


def remat_apply(fn, remat: bool, *args):
    """``fn(*args)``, its activations recomputed in the backward instead
    of kept (``torch.utils.checkpoint``, non-reentrant) when ``remat`` is
    set and grad is enabled; otherwise a plain call, so a serving forward
    launches and computes exactly what it would without it."""
    if remat and torch.is_grad_enabled():
        ctx = act_sharding.remat_context()
        kw = {"context_fn": lambda: (contextlib.nullcontext(), ctx())
              } if ctx is not None else {}
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args)


def layer(tree: Any, i: int) -> Any:
    """Slice ``i`` of every stacked leaf of ``tree`` (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def _enc_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, arch_type="dense",
                               n_layers=cfg.encoder_layers,
                               d_ff=cfg.d_ff or 4 * cfg.d_model,
                               is_encoder_decoder=False)


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype: torch.dtype = torch.float32, device: Any = "cuda"
                ) -> Params:
    """Random parameters drawn on ``device`` from ``gen`` (which must live
    there), in the JAX package's tree layout."""
    d, vp = cfg.d_model, cfg.padded_vocab
    p: Params = {
        "embed": embed_init(gen, vp, d, dtype, device=device),
        "blocks": init_blocks(gen, cfg, (cfg.n_layers,), dtype, device,
                              cross=cfg.is_encoder_decoder),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": stacked_dense(gen, (), d, vp, dtype, device),
    }
    if cfg.is_encoder_decoder:
        p["enc_blocks"] = init_blocks(gen, _enc_cfg(cfg), (cfg.encoder_layers,),
                                      dtype, device)
        p["enc_norm"] = torch.ones((d,), dtype=dtype, device=device)
        p["enc_pos"] = embed_init(gen, cfg.encoder_seq, d, dtype, device=device)
    if cfg.frontend_tokens:
        p["projector"] = stacked_dense(gen, (), cfg.frontend_dim, d, dtype,
                                       device)
    return p


# --------------------------------------------------------------------------
# MoE: sort-based capacity dispatch
# --------------------------------------------------------------------------

def route(p: Params, x: torch.Tensor, cfg: ArchConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's top-k experts and their renormalised weights, ``[T, k]``
    each."""
    return _top_k(x @ p["router"], cfg)


def _top_k(logits: torch.Tensor, cfg: ArchConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`route` from the router's logits ``[T, E]``.  A stable
    descending sort puts the lower expert first on a tie, as
    ``jax.lax.top_k`` does."""
    probs = torch.softmax(logits.float(), dim=-1)                # [T, E]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p = top_p[:, :cfg.experts_per_token]
    top_e = top_e[:, :cfg.experts_per_token]
    return top_p / top_p.sum(dim=-1, keepdim=True), top_e


def _moe_order(logits: torch.Tensor, cfg: ArchConfig):
    """Sort one group's (token, expert) pairs by expert, from its router
    logits ``[t, E]``: (se, st, sp, rank) ``[t*k]`` each, a pair's rank
    its place in its expert's buffer."""
    t = logits.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    top_p, top_e = _top_k(logits, cfg)
    flat_e = top_e.reshape(-1)
    flat_p = top_p.reshape(-1)
    flat_t = torch.arange(t, device=logits.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sp = flat_e[order], flat_t[order], flat_p[order]
    starts = torch.searchsorted(se, torch.arange(e, device=logits.device))
    rank = torch.arange(t * k, device=logits.device) - starts[se]
    return se, st, sp, rank


def _moe_scatter(x: torch.Tensor, se, st, rank, e: int,
                 cap: int) -> torch.Tensor:
    """Scatter each of one group's tokens ``x`` [t, d] into its expert's
    buffer at its rank: [E, C, d]; ranks >= ``cap`` are dropped."""
    # dropped pairs land in a dump row past the capacity, cut off after
    buf = torch.zeros((e, cap + 1, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    buf[se, rank.clamp(max=cap)] = x[st]
    return buf[:, :cap]


def _moe_combine(out: torch.Tensor, se, st, sp, rank, t: int) -> torch.Tensor:
    cap = out.shape[1]
    keep = (rank < cap)[:, None]
    contrib = torch.where(keep, out[se, rank.clamp(max=cap - 1)], 0.0)
    contrib = contrib * sp.to(out.dtype)[:, None]
    return torch.zeros((t, out.shape[-1]), dtype=out.dtype,
                       device=out.device).index_add_(0, st, contrib)


def _per_group(fn, *groups: torch.Tensor):
    """``fn`` on each group (the dim 0 of every input), its results
    stacked."""
    out = [fn(*g) for g in zip(*groups)]
    if isinstance(out[0], tuple):
        return tuple(torch.stack(r) for r in zip(*out))
    return torch.stack(out)


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: [T, d] token-flattened; dispatched in G group-local routings
    (``act_sharding.moe_groups()``, 1 unless a caller installs more).

    Under a ``DTensor`` trace each step runs on its shard's own groups, as
    the JAX package's vmap over the groups (which ride the data axis) is
    partitioned: the router's products on the tokens split along ``d``
    (their partial logits all-reduced), the routing on the whole logits,
    and the scatter into the buffers on the split tokens (the buffers are
    gathered by the dispatch constraint)."""
    t, d = x.shape
    g = act_sharding.moe_groups()
    if t % g != 0 or t // g < cfg.n_experts:
        g = 1
    tg = t // g
    cap = int(cfg.capacity_factor * tg * cfg.experts_per_token / cfg.n_experts)
    cap = max(8, min(cap, tg))
    xg = x.reshape(g, tg, d)
    logits = on_labelled_shards(
        lambda xg, r: _per_group(lambda xl: xl @ r, xg), (xg, p["router"]),
        "gtd,de->gte", "gd")
    se, st, sp, rank = on_local_shards(
        lambda lg: _per_group(lambda lt: _moe_order(lt, cfg), lg), (logits,),
        (0,), n_out=4, spread=())
    bufs = on_labelled_shards(
        lambda *a: _per_group(
            lambda *ga: _moe_scatter(*ga, e=cfg.n_experts, cap=cap), *a),
        (xg, se, st, rank), "gtd,gk,gk,gk->gecd", "gd")
    bufs = act_sharding.constrain_moe(bufs, "dispatch")    # [G, E, C, d]
    h = F.silu(torch.einsum("gecd,edf->gecf", bufs, p["moe_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", bufs, p["moe_up"])
    h = act_sharding.constrain_moe(h, "hidden")            # [G, E, C, ff]
    out = torch.einsum("gecf,efd->gecd", h, p["moe_down"])
    out = act_sharding.constrain_moe(out, "out")           # [G, E, C, d]
    yg = on_local_shards(
        lambda *a: _per_group(lambda *ga: _moe_combine(*ga, t=tg), *a),
        (out, se, st, sp, rank), (0,), spread=())
    return yg.reshape(t, d).to(x.dtype)


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _qkv(p: Params, x: torch.Tensor, cfg: ArchConfig):
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, p["norm1"])
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _attn(p: Params, x: torch.Tensor, cfg: ArchConfig, rope,
          positions: Optional[torch.Tensor] = None, causal: bool = True,
          window: Optional[int] = None) -> torch.Tensor:
    """Self-attention sublayer over the whole sequence (forward and
    encoder).  The JAX package's ``_attn`` also takes a KV cache, which no
    caller there passes: decode goes through :func:`_decode_attn_full` and
    :func:`_decode_attn_ring`."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rope
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    out = gqa_attention(q, k, v, causal=causal, window=window)
    return x + out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]


def _cross_attn(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    b, s, _ = x.shape
    hd, se = cfg.head_dim, enc_out.shape[1]
    h = rms_norm(x, p["cross_norm"])
    q = (h @ p["cwq"]).reshape(b, s, cfg.n_heads, hd)
    # a decode cache may hold enc_out in another dtype: promote as JAX does
    k = qdense(enc_out, p["cwk"]).reshape(b, se, cfg.n_kv_heads, hd)
    v = qdense(enc_out, p["cwv"]).reshape(b, se, cfg.n_kv_heads, hd)
    out = gqa_attention(q, k, v, causal=False)
    return x + out.reshape(b, s, cfg.n_heads * hd) @ p["cwo"]


def _mlp(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, p["norm2"])
    if cfg.arch_type == "moe":
        b, s, d = h.shape
        y = moe_apply(p, h.reshape(b * s, d), cfg).reshape(b, s, d)
    else:
        y = swiglu(p["mlp"], h)
    return x + y


def block_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, rope,
                enc_out: Optional[torch.Tensor] = None, **attn_kw
                ) -> torch.Tensor:
    x = _attn(p, x, cfg, rope, **attn_kw)
    if enc_out is not None:
        x = _cross_attn(p, x, enc_out, cfg)
    return _mlp(p, x, cfg)


# --------------------------------------------------------------------------
# Encoder (enc-dec archs)
# --------------------------------------------------------------------------

def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor,
           rope) -> torch.Tensor:
    """frames: [B, enc_seq, d_model] stub-frontend embeddings.  Its
    attention is non-causal and mask-free, so it takes the flash-attention
    kernel wherever ``gqa_attention`` routes it there."""
    x = frames + params["enc_pos"][None, : frames.shape[1]]
    enc_cfg = _enc_cfg(cfg)
    for i in range(params["enc_blocks"]["wq"].shape[0]):
        p = layer(params["enc_blocks"], i)
        x = _mlp(p, _attn(p, x, enc_cfg, rope, causal=False), enc_cfg)
    return rms_norm(x, params["enc_norm"])


# --------------------------------------------------------------------------
# Forward (prefill logits)
# --------------------------------------------------------------------------

def forward(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,                       # [B, S]
    frames: Optional[torch.Tensor] = None,      # enc-dec: [B, enc_seq, d]
    patches: Optional[torch.Tensor] = None,     # vlm: [B, P, frontend_dim]
    remat: bool = True,
    last_only: bool = False,
) -> torch.Tensor:
    """Logits ``[B, S, padded_vocab]``.  ``remat`` rematerialises each
    decoder layer in the backward when grad is enabled (the training
    path's memory plan); it computes the same values, and
    ``make_prefill_step`` passes ``remat=False``."""
    s = tokens.shape[1]
    # F.embedding, not indexing: the same gather, whose backward sums a
    # repeated token's rows in a fixed order (indexing's index_put_
    # accumulates in whatever order threads run), so a training
    # step's gradients repeat bit for bit
    x = F.embedding(tokens, params["embed"]).to(params["lm_head"].dtype)
    if patches is not None:
        proj = patches @ params["projector"]
        x = torch.cat([proj.to(x.dtype), x], dim=1)
    dev = x.device
    rope = rope_frequencies(cfg.head_dim, x.shape[1], cfg.rope_theta,
                            device=dev)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_rope = rope_frequencies(cfg.head_dim, cfg.encoder_seq,
                                    cfg.rope_theta, device=dev)
        enc_out = encode(params, cfg, frames, enc_rope)
    def body(p, x):
        return constrain(block_apply(p, x, cfg, rope, enc_out=enc_out,
                                     causal=True, window=cfg.sliding_window))

    x = constrain(x)
    for i in range(cfg.n_layers):
        x = remat_apply(body, remat, layer(params["blocks"], i), x)
    x = rms_norm(x, params["final_norm"])
    if patches is not None:
        x = x[:, -s:]                          # only the text positions
    if last_only:
        x = x[:, -1:]
    return mask_vocab(x @ params["lm_head"], cfg.vocab)


# --------------------------------------------------------------------------
# Decode (serve_step)
# --------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, seq_len: int,
                      dtype: torch.dtype = torch.bfloat16, ring: bool = False,
                      window: int = 8192, device: Any = "cuda"
                      ) -> Dict[str, Any]:
    """KV cache for decode.  ``ring=True`` allocates a sliding-window ring
    buffer: K is stored unroped and roped at read time with
    window-relative positions.  ``pos`` is a Python int."""
    size = min(window, seq_len) if ring else seq_len
    shape = (cfg.n_layers, batch, size, cfg.n_kv_heads, cfg.head_dim)
    cache: Dict[str, Any] = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }
    if cfg.is_encoder_decoder:
        cache["enc_out"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                       dtype=dtype, device=device)
    return cache


def _decode_scores(q, k_new, v_new, ck, cv, pos: int, start: int,
                   window: Optional[int]):
    """One shard's first half of the flash decode: writes this step's K/V
    into its cache slice ``ck``/``cv`` in place, and only when ``pos``
    falls inside it (slots ``start`` to ``start + sl - 1``), then its
    scaled scores ``[b, hkv, g, s, sl]`` under the ``slots <= pos`` mask
    (and the window's), and the mask."""
    b, s, hq, hd = q.shape
    sl, hkv = ck.shape[1], ck.shape[2]
    if start <= pos < start + sl:
        update_slice_(ck, k_new.to(ck.dtype), pos - start)
        update_slice_(cv, v_new.to(cv.dtype), pos - start)
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, s, hkv, hq // hkv, hd)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, ck.float())
    slots = start + torch.arange(sl, device=q.device)
    mask = slots <= pos
    if window is not None:
        mask = mask & (slots > pos - window)
    return torch.where(mask, sc, torch.finfo(torch.float32).min), mask


def _decode_partials(sc, mask, m_glob, cv):
    """One shard's second half: ``exp(sc - m_glob)`` under the mask, its
    sum ``l`` and its product with the shard's values ``acc``."""
    p_ = torch.where(mask, torch.exp(sc - m_glob[..., None]), 0.0)
    return p_.sum(dim=-1), torch.einsum("bhgqk,bkhd->bqhgd", p_, cv.float())


def _decode_finish(l, acc, q):
    """The merged sums to the output ``[b, s, hq, hd]``: a zero sum (a row
    that sees no slot) is set to 1 before the division."""
    b, s, hq, hd = q.shape
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, hq, hd).to(q.dtype)


def _flash_decode_shardmap(shards, q, k, v, ck, cv, pos: int,
                           window: Optional[int]) -> torch.Tensor:
    """Flash-decode over a sequence-sharded KV cache (the JAX package's
    ``_flash_decode_shardmap``).

    Each shard of the cache's sequence axis updates its slice (iff ``pos``
    falls inside it) and computes its scores; the global max comes first,
    then each shard's ``exp(sc - max)`` sums and products, which are
    summed across the shards: the order of the reference's pmax/psum, so
    the rounding follows it.  One local step serves two meshes:

    * a :class:`~repro_torch.core.mesh.Submesh` of k slots (serving): the
      cache's K/V are lists of per-slot parts (:func:`shard_decode_cache`),
      each written in place on its slot; the merges move the partials to
      the home slot with device copies;
    * ``(DeviceMesh, axis, dp)`` (the dry run): the cache is a ``DTensor``
      sequence-sharded over ``axis``; the step runs in ``local_map`` (the
      counterpart of ``shard_map``) and the merges are the functional
      ``all_reduce``, MAX then SUM.
    """
    if hasattr(shards, "devices"):
        return _flash_decode_slots(shards, q, k, v, ck, cv, pos, window)
    return _flash_decode_mesh(shards, q, k, v, ck, cv, pos, window)


def _flash_decode_slots(mesh, q, k, v, cks, cvs, pos, window):
    home = q.device
    parts, start = [], 0
    for dev, ck, cv in zip(mesh.devices, cks, cvs):
        sc, mask = _decode_scores(q.to(dev), k.to(dev), v.to(dev), ck, cv,
                                  pos, start, window)
        parts.append((sc, mask, cv))
        start += ck.shape[1]
    m_glob = parts[0][0].amax(dim=-1).to(home)
    for sc, _, _ in parts[1:]:
        m_glob = torch.maximum(m_glob, sc.amax(dim=-1).to(home))
    l = acc = None
    for sc, mask, cv in parts:
        l_i, acc_i = _decode_partials(sc, mask, m_glob.to(sc.device), cv)
        l = l_i.to(home) if l is None else l + l_i.to(home)
        acc = acc_i.to(home) if acc is None else acc + acc_i.to(home)
    return _decode_finish(l, acc, q)


def _flash_decode_mesh(shards, q, k, v, ck, cv, pos, window):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, axis, dp = shards
    names = mesh.mesh_dim_names
    dp = dp if isinstance(dp, tuple) else (dp,)
    rows = tuple(Shard(0) if a in dp else Replicate() for a in names)
    cache = tuple(Shard(0) if a in dp else Shard(1) if a == axis
                  else Replicate() for a in names)
    group = (mesh, names.index(axis))

    def local(q, k_new, v_new, ck, cv):
        start = mesh.get_local_rank(axis) * ck.shape[1]
        sc, mask = _decode_scores(q, k_new, v_new, ck, cv, pos, start,
                                  window)
        m_glob = funcol.all_reduce(sc.amax(dim=-1), "max", group)
        l, acc = _decode_partials(sc, mask, m_glob, cv)
        l = funcol.all_reduce(l, "sum", group)
        acc = funcol.all_reduce(acc, "sum", group)
        return _decode_finish(l, acc, q)

    # a list of placements per tensor: a tuple reads as one per output
    rows, cache = list(rows), list(cache)
    return local_map(local, out_placements=rows,
                     in_placements=(rows, rows, rows, cache, cache),
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, k, v, ck, cv)


def shard_decode_cache(cache: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``cache`` with its K/V sequence axis split over the slots of a
    :class:`~repro_torch.core.mesh.Submesh`: part i a contiguous copy on
    slot i, for :func:`decode_step` under ``decode_shards=mesh``."""
    out = dict(cache)
    for name in ("k", "v"):
        t = cache[name]
        if t.shape[2] % mesh.size:
            raise ValueError(f"shard_decode_cache: {t.shape[2]} slots do "
                             f"not split into {mesh.size} parts")
        out[name] = [p.to(d, copy=True, memory_format=torch.contiguous_format)
                     for p, d in zip(torch.chunk(t, mesh.size, dim=2),
                                     mesh.devices)]
    return out


def gather_decode_cache(cache: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The inverse of :func:`shard_decode_cache`: the parts joined on the
    home slot."""
    return {**cache, "k": mesh.gather(cache["k"], dim=2),
            "v": mesh.gather(cache["v"], dim=2)}


def _decode_attn_full(p, x, cfg: ArchConfig, rope, pos: int, ck, cv,
                      window: Optional[int]) -> torch.Tensor:
    """Decode attention with absolute-roped keys over the full cache; writes
    this step's K/V into ``ck``/``cv`` in place."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rope
    qpos = torch.full((s,), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, cos, sin, qpos)
    k = apply_rope(k, cos, sin, qpos)
    shards = act_sharding.decode_shards()
    if shards is not None:
        out = _flash_decode_shardmap(shards, q, k, v, ck, cv, pos, window)
        return x + out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
    update_slice_(ck, k.to(ck.dtype), pos)
    update_slice_(cv, v.to(cv.dtype), pos)
    size = ck.shape[1]
    slots = torch.arange(size, device=x.device)
    neg = torch.finfo(torch.float32).min
    mask = torch.where(slots <= pos, 0.0, neg)
    if window is not None:      # neg + neg reaches -inf, as in the reference
        mask = mask + torch.where(slots > pos - window, 0.0, neg)
    mask = mask[None, None, None, :].expand(b, 1, s, size)
    out = gqa_attention(q, ck, cv, causal=False, mask=mask)
    return x + out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]


def _decode_attn_ring(p, x, cfg: ArchConfig, rope, pos: int, ck, cv
                      ) -> torch.Tensor:
    """Ring-buffer sliding-window decode attention.  The cache stores
    unroped keys; every read ropes the whole window with positions relative
    to ``base = max(pos - size + 1, 0)``: exact for RoPE, which depends
    only on position differences, and O(window) work."""
    b, s, _ = x.shape
    size = ck.shape[1]
    q, k, v = _qkv(p, x, cfg)
    write_idx = pos % size
    update_slice_(ck, k.to(ck.dtype), write_idx)
    update_slice_(cv, v.to(cv.dtype), write_idx)
    slots = torch.arange(size, device=x.device)
    off = torch.remainder(write_idx - slots, size)
    abs_pos = pos - off                       # absolute position of each slot
    base = max(pos - size + 1, 0)
    rel_k = torch.clamp(abs_pos - base, 0, size - 1)
    rel_q = min(max(pos - base, 0), size - 1)
    cos, sin = rope
    q = apply_rope(q, cos, sin,
                   torch.full((s,), rel_q, dtype=torch.int64, device=x.device))
    k_all = apply_rope(ck, cos, sin, rel_k)
    neg = torch.finfo(torch.float32).min
    mask = torch.where(abs_pos >= 0, 0.0, neg)
    mask = mask[None, None, None, :].expand(b, 1, s, size)
    out = gqa_attention(q, k_all, cv, causal=False, mask=mask)
    return x + out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]


def decode_step(
    params: Params,
    cfg: ArchConfig,
    cache: Dict[str, Any],
    token: torch.Tensor,                # [B] int — ONE new token per row
    ring: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    pos = int(cache["pos"])
    # a list of per-slot parts under a Submesh's decode_shards
    parts = isinstance(cache["k"], (list, tuple))
    size = (sum(c.shape[2] for c in cache["k"]) if parts
            else cache["k"].shape[2])
    x = params["embed"][token][:, None, :].to(params["lm_head"].dtype)
    rope = rope_frequencies(cfg.head_dim, size, cfg.rope_theta,
                            device=x.device)
    enc_out = cache.get("enc_out")
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        if parts:
            ck, cv = [c[i] for c in cache["k"]], [c[i] for c in cache["v"]]
        else:
            ck, cv = cache["k"][i], cache["v"][i]
        if ring:
            x = _decode_attn_ring(p, x, cfg, rope, pos, ck, cv)
        else:
            x = _decode_attn_full(p, x, cfg, rope, pos, ck, cv,
                                  cfg.sliding_window)
        if enc_out is not None:
            x = _cross_attn(p, x, enc_out, cfg)
        x = _mlp(p, x, cfg)
    x = rms_norm(x, params["final_norm"])
    logits = mask_vocab((x @ params["lm_head"])[:, 0], cfg.vocab)
    return logits, {**cache, "pos": pos + 1}
