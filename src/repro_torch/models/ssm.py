"""xLSTM stack (mLSTM matrix-memory + sLSTM scalar-memory blocks).

[arXiv:2405.04517]  The assigned xlstm-1.3b config is 48 blocks, 4 heads,
d_model 2048 and no separate FFN (d_ff=0): temporal mixing carries the
capacity.  Pattern: 7 mLSTM : 1 sLSTM per super-block (the paper's 7:1).

mLSTM uses the chunked linear-attention formulation of the JAX package:

    C_t = f_t C_{t-1} + i_t k_t v_t^T          (matrix memory, per head)
    n_t = f_t n_{t-1} + i_t k_t                (normalizer)
    h_t = (q_t C_t) / max(|q_t . n_t|, 1)

with scalar-per-head gates f and i (both sigmoid).  Each chunk is a few
batched products; the chunks run in a Python loop (the JAX package's
``lax.scan``).  Decode is the exact O(1) recurrence.

sLSTM blocks are per-channel scalar recurrences ``c_t = f_t c_{t-1} +
i_t z_t``, ``h = o * c``, evaluated with the associative scan that the
port's RG-LRU plain version already mirrors
(:func:`repro_torch.kernels.rglru_scan.ref.linear_scan`).

``forward(remat=True)`` rematerialises each super-block in the backward
when grad is enabled, as the JAX package's ``jax.checkpoint`` does; the
remainder mLSTM blocks are not rematerialised.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.meta import on_labelled_shards, on_local_shards
from repro_torch.kernels.rglru_scan.ref import linear_scan
from repro_torch.models import transformer as tfm
from repro_torch.models.act_sharding import constrain
from repro_torch.models.base import ArchConfig
from repro_torch.nn.layers import embed_init, mask_vocab, rms_norm

Params = Dict[str, Any]

PATTERN = ("m",) * 7 + ("s",)       # 7 mLSTM : 1 sLSTM
N_M = PATTERN.count("m")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_mlstm(gen: torch.Generator, cfg: ArchConfig, lead,
                dtype: torch.dtype, device: Any) -> Params:
    d, h, lead = cfg.d_model, cfg.n_heads, tuple(lead)

    def dense(d_in, d_out):
        return tfm.stacked_dense(gen, lead, d_in, d_out, dtype, device)

    return {
        "norm": torch.ones((*lead, d), dtype=dtype, device=device),
        "wq": dense(d, d),
        "wk": dense(d, d),
        "wv": dense(d, d),
        "wif": dense(d, 2 * h),     # input + forget gates
        "wo": dense(d, d),
        "wog": dense(d, d),         # output gate
    }


def _init_slstm(gen: torch.Generator, cfg: ArchConfig, lead,
                dtype: torch.dtype, device: Any) -> Params:
    d, lead = cfg.d_model, tuple(lead)

    def dense(d_in, d_out):
        return tfm.stacked_dense(gen, lead, d_in, d_out, dtype, device)

    return {
        "norm": torch.ones((*lead, d), dtype=dtype, device=device),
        "wz": dense(d, d),
        "wi": dense(d, d),
        "wf": dense(d, d),
        "wo_gate": dense(d, d),
        "wo": dense(d, d),
    }


def _super_layout(cfg: ArchConfig) -> Tuple[int, int]:
    return divmod(cfg.n_layers, len(PATTERN))


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype: torch.dtype = torch.float32, device: Any = "cuda"
                ) -> Params:
    n_super, rem = _super_layout(cfg)
    p: Params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": tfm.stacked_dense(gen, (), cfg.d_model, cfg.padded_vocab,
                                     dtype, device),
    }
    if n_super:
        p["mlstm"] = _init_mlstm(gen, cfg, (n_super, N_M), dtype, device)
        p["slstm"] = _init_slstm(gen, cfg, (n_super, 1), dtype, device)
    if rem:
        p["rem_mlstm"] = _init_mlstm(gen, cfg, (rem,), dtype, device)
    return p


# --------------------------------------------------------------------------
# mLSTM chunked forward
# --------------------------------------------------------------------------

def _mlstm_gates(p: Params, xn: torch.Tensor, cfg: ArchConfig):
    b, s, d = xn.shape
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    q = (xn @ p["wq"]).reshape(b, s, h, hd)
    k = (xn @ p["wk"]).reshape(b, s, h, hd) / torch.tensor(
        math.sqrt(hd), dtype=xn.dtype, device=xn.device)
    v = (xn @ p["wv"]).reshape(b, s, h, hd)
    gif = xn @ p["wif"]
    ig = torch.sigmoid(gif[..., :h])                          # [b,s,h]
    lf = F.logsigmoid(gif[..., h:].float())                   # log forget
    return q, k, v, ig, lf


def mlstm_chunked(p: Params, x: torch.Tensor, cfg: ArchConfig,
                  state: Optional[Tuple] = None
                  ) -> Tuple[torch.Tensor, Tuple]:
    """x: [B,S,d]; S must be a multiple of the chunk (padded upstream).
    Under a ``DTensor`` trace the chunks run on each shard's own rows and
    heads."""
    b, s, d = x.shape
    hh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    c = min(cfg.ssm_chunk, s)
    xn = rms_norm(x, p["norm"])
    q, k, v, ig, lf = _mlstm_gates(p, xn, cfg)
    state = () if state is None else tuple(state)
    h, C, n = on_labelled_shards(
        lambda *t: _mlstm_chunks(c, *t), (q, k, v, ig, lf, *state),
        "bshd,bshd,bshe,bsh,bsh" + ",bhde,bhd" * bool(state)
        + "->bshe,bhde,bhd", "bh")
    h = h.reshape(b, s, hh * hd)
    og = torch.sigmoid(xn @ p["wog"])
    out = (h.to(x.dtype) * og) @ p["wo"]
    return x + out, (C, n)


def _mlstm_chunks(c: int, q, k, v, ig, lf, C=None, n=None):
    """The chunked mLSTM over ``[B, S, H, hd]`` gates from the state ``(C,
    n)`` (zeros if not given): ``(h [B, S, H, hd], C, n)``."""
    b, s, hh, hd = q.shape
    if C is None:
        C = torch.zeros((b, hh, hd, hd), device=q.device)
        n = torch.zeros((b, hh, hd), device=q.device)
    tmask = (torch.arange(c, device=q.device)[:, None]
             >= torch.arange(c, device=q.device)[None, :])
    hs = []
    for lo in range(0, s, c):
        qc, kc, vc = (t[:, lo:lo + c] for t in (q, k, v))
        igc, lfc = ig[:, lo:lo + c], lf[:, lo:lo + c]
        L = torch.cumsum(lfc, dim=1)             # [B, c, H] inclusive decay
        qd = qc * torch.exp(L)[..., None]        # prior state's contribution
        h_inter = torch.einsum("bthd,bhde->bthe", qd, C)
        n_inter = torch.einsum("bthd,bhd->bth", qd, n)
        # intra-chunk masked linear attention
        rel = L[:, :, None, :] - L[:, None, :, :]         # [B, t, s, H]
        w = torch.where(tmask[None, :, :, None], torch.exp(rel), 0.0)
        w = w * igc[:, None, :, :]                        # input gate
        scores = torch.einsum("bthd,bshd->btsh", qc.float(), kc.float())
        sw = scores * w
        h_intra = torch.einsum("btsh,bshe->bthe", sw, vc.float())
        n_intra = sw.sum(dim=2)                           # q_t . n_t (intra)
        num = h_inter + h_intra                           # [B, c, H, hd]
        den = n_inter + n_intra                           # [B, c, H]
        hs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        # state update to the end of the chunk
        tail = torch.exp(L[:, -1:, :] - L)                # decay from s to end
        kw = kc.float() * (igc * tail)[..., None]
        end = torch.exp(L[:, -1])
        C = C * end[:, :, None, None] + torch.einsum(
            "bshd,bshe->bhde", kw, vc.float())
        n = n * end[:, :, None] + kw.sum(dim=1)
    return torch.cat(hs, dim=1), C, n


def mlstm_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: Tuple) -> Tuple[torch.Tensor, Tuple]:
    """x: [B,1,d]: the exact single-step recurrence."""
    b = x.shape[0]
    hh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    xn = rms_norm(x, p["norm"])
    q, k, v, ig, lf = _mlstm_gates(p, xn, cfg)
    C, n = state
    f = torch.exp(lf[:, 0])                                # [B,H]
    i = ig[:, 0]
    k0, q0 = k[:, 0].float(), q[:, 0].float()
    kv = torch.einsum("bhd,bhe->bhde", k0, v[:, 0].float())
    C = C * f[..., None, None] + kv * i[..., None, None]
    n = n * f[..., None] + k0 * i[..., None]
    num = torch.einsum("bhd,bhde->bhe", q0, C)
    den = torch.einsum("bhd,bhd->bh", q0, n)
    h = (num / torch.clamp(den.abs(), min=1.0)[..., None]).reshape(b, 1, hh * hd)
    og = torch.sigmoid(xn @ p["wog"])
    out = (h.to(x.dtype) * og) @ p["wo"]
    return x + out, (C, n)


# --------------------------------------------------------------------------
# sLSTM (scalar memory, associative scan)
# --------------------------------------------------------------------------

def slstm_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    xn = rms_norm(x, p["norm"])
    z = torch.tanh(xn @ p["wz"]).float()
    i = torch.sigmoid(xn @ p["wi"]).float()
    f = torch.sigmoid(xn @ p["wf"]).float()
    o = torch.sigmoid(xn @ p["wo_gate"])
    iz = i * z
    if state is not None:
        iz[:, 0] += f[:, 0] * state          # carry-in: f_1 * c_0
    _, cseq = on_local_shards(linear_scan, (f, iz), (0, 2), n_out=2,
                              spread=())
    out = (o * cseq.to(x.dtype)) @ p["wo"]
    return x + out, cseq[:, -1]


def slstm_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xn = rms_norm(x, p["norm"])
    z = torch.tanh(xn @ p["wz"])[:, 0].float()
    i = torch.sigmoid(xn @ p["wi"])[:, 0].float()
    f = torch.sigmoid(xn @ p["wf"])[:, 0].float()
    o = torch.sigmoid(xn @ p["wo_gate"])
    c = f * state + i * z
    out = (o * c[:, None].to(x.dtype)) @ p["wo"]
    return x + out, c


# --------------------------------------------------------------------------
# Full stack
# --------------------------------------------------------------------------

def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            remat: bool = True, last_only: bool = False, **_: Any
            ) -> torch.Tensor:
    s = tokens.shape[1]
    pad = (-s) % min(cfg.ssm_chunk, s)
    # F.embedding: a backward that repeats bit for bit (transformer.forward)
    x = F.embedding(tokens, params["embed"]).to(params["lm_head"].dtype)
    x = F.pad(x, (0, 0, 0, pad))
    n_super, rem = _super_layout(cfg)

    def super_body(mp, sp, x):
        for j in range(N_M):
            x, _ = mlstm_chunked(tfm.layer(mp, j), x, cfg)
        x, _ = slstm_forward(tfm.layer(sp, 0), x, cfg)
        return constrain(x)

    x = constrain(x)
    for si in range(n_super):
        x = tfm.remat_apply(super_body, remat, tfm.layer(params["mlstm"], si),
                            tfm.layer(params["slstm"], si), x)
    for ri in range(rem):
        x, _ = mlstm_chunked(tfm.layer(params["rem_mlstm"], ri), x, cfg)
    x = rms_norm(x[:, :s], params["final_norm"])
    if last_only:
        x = x[:, -1:]
    return mask_vocab(x @ params["lm_head"], cfg.vocab)


def init_decode_cache(cfg: ArchConfig, batch: int, seq_len: int,
                      dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
                      **_: Any) -> Dict[str, Any]:
    """Recurrent states, all f32 whatever ``dtype`` asks (as in the JAX
    package); their size does not depend on ``seq_len``."""
    n_super, rem = _super_layout(cfg)
    hh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    cache: Dict[str, Any] = {
        "C": zeros(n_super, N_M, batch, hh, hd, hd),
        "n": zeros(n_super, N_M, batch, hh, hd),
        "c_s": zeros(n_super, batch, cfg.d_model),
        "pos": 0,
    }
    if rem:
        cache["C_rem"] = zeros(rem, batch, hh, hd, hd)
        cache["n_rem"] = zeros(rem, batch, hh, hd)
    return cache


def decode_step(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                token: torch.Tensor, **_: Any
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token per row; writes the states in place."""
    x = params["embed"][token][:, None, :].to(params["lm_head"].dtype)
    n_super, rem = _super_layout(cfg)

    def mlstm(p, x, C, n):
        x, (Cj, nj) = mlstm_decode(p, x, cfg, (C, n))
        C.copy_(Cj)
        n.copy_(nj)
        return x

    for si in range(n_super):
        mp = tfm.layer(params["mlstm"], si)
        for j in range(N_M):
            x = mlstm(tfm.layer(mp, j), x, cache["C"][si, j], cache["n"][si, j])
        s0 = tfm.layer(tfm.layer(params["slstm"], si), 0)
        x, c_s = slstm_decode(s0, x, cfg, cache["c_s"][si])
        cache["c_s"][si].copy_(c_s)
    for ri in range(rem):
        x = mlstm(tfm.layer(params["rem_mlstm"], ri), x, cache["C_rem"][ri],
                  cache["n_rem"][ri])
    x = rms_norm(x, params["final_norm"])
    logits = mask_vocab((x @ params["lm_head"])[:, 0], cfg.vocab)
    return logits, {**cache, "pos": int(cache["pos"]) + 1}
