"""Public wrapper around the flash-attention kernel.

``mha(q, k, v)`` takes the framework-wide ``[B, S, H, D]`` layout, handles
GQA head expansion, and calls :func:`~.kernel.flash_attention` on the
``[B*H, S, D]`` view: the CUDA kernel for a CUDA tensor, its plain version
for a CPU tensor.  Forward only: the serving path needs no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention


def mha(
    q: torch.Tensor,            # [B, Sq, Hq, D]
    k: torch.Tensor,            # [B, Sk, Hkv, D]
    v: torch.Tensor,            # [B, Sk, Hkv, D]
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    group = hq // hkv
    if group > 1:               # GQA: expand kv heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    qt = q.permute(0, 2, 1, 3).reshape(b * hq, sq, d).contiguous()
    kt = k.permute(0, 2, 1, 3).reshape(b * hq, sk, d).contiguous()
    vt = v.permute(0, 2, 1, 3).reshape(b * hq, sk, d).contiguous()
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    return out.reshape(b, hq, sq, d).permute(0, 2, 1, 3)
