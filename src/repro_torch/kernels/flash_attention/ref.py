"""Plain PyTorch versions of the flash-attention kernels (f32 math): the
forward, its row log-sum-exp, the backward, the split-KV route's two
passes, and the split planes of the head-dim-128 route's pre-pass."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,            # [BH, Sq, D]
    k: torch.Tensor,            # [BH, Sk, D]
    v: torch.Tensor,            # [BH, Sk, D]
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    bh, sq, d = q.shape
    _, sk, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)       # fully-masked rows
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype)


def _scores(q, k, causal, window, scale):
    """Scaled f32 scores [BH, Sq, Sk] and the visibility mask [Sq, Sk]."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return s, mask


def attention_lse_ref(
    q: torch.Tensor,            # [BH, Sq, D]
    k: torch.Tensor,            # [BH, Sk, D]
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Each row's log-sum-exp of the scaled, masked scores, [BH, Sq] f32:
    what the forward kernel writes for the backward (+inf for a row that
    sees no key, whose probabilities are all 0)."""
    s, mask = _scores(q, k, causal, window, scale)
    lse = torch.logsumexp(s.masked_fill(~mask[None], float("-inf")), dim=-1)
    return torch.where(torch.isneginf(lse), float("inf"), lse)


def attention_bwd_ref(
    q: torch.Tensor,            # [BH, Sq, D]
    k: torch.Tensor,            # [BH, Sk, D]
    v: torch.Tensor,            # [BH, Sk, D]
    o: torch.Tensor,            # [BH, Sq, D], the forward's output
    lse: torch.Tensor,          # [BH, Sq], the forward's row log-sum-exp
    do: torch.Tensor,           # [BH, Sq, D], the output's gradient
    scale: Optional[float] = None,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> tuple:
    """Plain version of the backward kernel, the VJP of :func:`attention_ref`
    written out: P = exp(S - lse) (0 where masked), Di = rowsum(dO o),
    dV = P^T dO, dS = P (dO v^T - Di), dQ = scale dS k, dK = scale dS^T q.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s, mask = _scores(q, k, causal, window, scale)
    p = torch.where(mask[None], torch.exp(s - lse.float()[..., None]), 0.0)
    dof = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    di = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - di)
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


NEG_INF = -1e30                 # the kernels' running-max floor


def attention_partial_ref(
    q: torch.Tensor,            # [BH, Sq, D]
    k: torch.Tensor,            # [BH, Sk, D]
    v: torch.Tensor,            # [BH, Sk, D]
    *,
    chunk: int,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> tuple:
    """Plain version of the split-KV kernel's first pass: attention of each
    query row over each run of ``chunk`` keys on its own.  Returns f32
    ``(o, m, l)``: ``o`` [C, BH, Sq, D] is the chunk's unnormalised output
    sum_k p_k v_k, ``m`` [C, BH, Sq] its row max of the scaled scores
    (``NEG_INF`` where the chunk holds no key of the row) and ``l`` its row
    sum of p_k = exp(s_k - m) (0 there)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    os_, ms, ls = [], [], []
    for c0 in range(0, sk, chunk):
        sc = s[:, :, c0:c0 + chunk]
        mc = mask[None, :, c0:c0 + chunk]
        m = sc.masked_fill(~mc, NEG_INF).amax(dim=-1, keepdim=True)
        p = torch.where(mc, torch.exp(sc - m), 0.0)
        os_.append(torch.einsum("bqk,bkd->bqd", p, v[:, c0:c0 + chunk].float()))
        ms.append(m[..., 0])
        ls.append(p.sum(dim=-1))
    return torch.stack(os_), torch.stack(ms), torch.stack(ls)


def merge_partials_ref(
    o: torch.Tensor,            # [C, BH, Sq, D]
    m: torch.Tensor,            # [C, BH, Sq]
    l: torch.Tensor,            # [C, BH, Sq]
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of the split-KV merge kernel:
    out = sum_c e^(m_c - M) o_c / sum_c e^(m_c - M) l_c with M = max_c m_c
    over the chunks that hold a key of the row (l_c > 0).  A chunk with
    l_c = 0 adds nothing, and a row with no key at all gives 0."""
    live = l > 0
    big = torch.where(live, m, NEG_INF).amax(dim=0, keepdim=True)
    w = torch.where(live, torch.exp(m - big), 0.0)
    num = (w[..., None] * torch.where(live[..., None], o, 0.0)).sum(dim=0)
    den = (w * l).sum(dim=0)
    den = torch.where(den == 0, 1.0, den)
    return (num / den[..., None]).to(dtype)


def _sw128(r, c):
    """Byte offset of the float at (row r, column c < 32) of a column of
    128-byte swizzled atoms: 16-byte chunk c // 4 of row r stored at chunk
    (c // 4) ^ (r % 8)."""
    return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4


def _tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits set to 0 (the kernels' ``split``)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_planes_ref(
    k: torch.Tensor,            # [BH, Sk, 128] f32
    v: torch.Tensor,            # [BH, Sk, 128] f32
    *,
    tile: int = 32,
) -> torch.Tensor:
    """The head-dim-128 route's split planes: [BH, ceil(Sk / tile), 4,
    tile * 128] f32, for each tile of keys K hi, K lo, V^T hi and V^T lo,
    each TF32 part cut (hi = cut(x), lo = cut(x - hi)), keys past Sk zero,
    laid out as the kernel's shared memory holds them.  K: key row r, dim d
    at column d // 32 of atoms (tile * 128 bytes each), position
    ``_sw128(r, d % 32)``.  V^T: dim row d, tile slot s at column s // 32 of
    atoms (128 * 128 bytes each), position ``_sw128(d, s % 32)``, where slot
    8g + i holds key 8g + (0, 2, 4, 6, 1, 3, 5, 7)[i]."""
    bh, sk, d = k.shape
    if d != 128 or tile % 32:
        raise ValueError(f"split_planes_ref: head dim {d}, tile {tile}")
    n = -(-sk // tile)
    pad = (0, 0, 0, n * tile - sk)
    kt = torch.nn.functional.pad(k.float(), pad).view(bh, n, tile, d)
    vt = torch.nn.functional.pad(v.float(), pad).view(bh, n, tile, d)
    rows = torch.arange(tile)[:, None]
    dims = torch.arange(d)[None, :]
    # K: float index of (key r, dim d) in the plane
    k_at = ((dims // 32) * tile * 128
            + _sw128(rows, dims % 32)) // 4                  # [tile, d]
    # V^T: float index of (dim row, slot) and the key each slot holds
    slots = torch.arange(tile)[None, :]
    v_at = ((slots // 32) * 128 * 128
            + _sw128(dims.T, slots % 32)) // 4               # [d, tile]
    perm = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    key_of = 8 * (slots[0] // 8) + perm[slots[0] % 8]        # [tile]
    out = torch.zeros((bh, n, 4, tile * d), dtype=torch.float32,
                      device=k.device)
    for i, (x, at) in enumerate(
            ((kt, k_at), (vt[:, :, key_of, :].transpose(-1, -2), v_at))):
        hi = _tf32_cut(x)
        lo = _tf32_cut(x - hi)
        flat = at.reshape(-1).to(k.device)
        out[:, :, 2 * i, flat] = hi.reshape(bh, n, -1)
        out[:, :, 2 * i + 1, flat] = lo.reshape(bh, n, -1)
    return out
