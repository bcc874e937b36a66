"""Plain PyTorch version of the flash-attention kernel (f32 math)."""

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
