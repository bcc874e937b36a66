"""Public wrapper around the flash-attention kernels.

``mha(q, k, v)`` takes the framework-wide ``[B, S, H, D]`` layout, handles
GQA head expansion, and calls :func:`~.kernel.flash_attention` on the
``[B*H, S, D]`` view: the CUDA kernel for a CUDA tensor, its plain version
for a CPU tensor.

Where autograd needs a gradient (grad enabled and an input that requires
one), the call goes through :class:`FlashAttention`, a
``torch.autograd.Function`` whose forward is the same kernel writing each
row's log-sum-exp as well and whose backward is the backward kernel
(:func:`~.kernel.flash_attention_bwd`); on the CPU both are the plain
versions.  It is the JAX package's ``custom_vjp`` around its Pallas
forward, whose backward differentiates the plain attention.  On the card
it launches its kernels or raises (bf16 and head dims 128 and 1024 have
no backward kernel): it never differentiates the plain version there.  A
call that needs no gradient, every serving call, takes the forward alone
and writes no log-sum-exp.  Meta tensors (the dry run) take the kernels'
meta routes.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention,
    flash_attention_bwd,
)


class FlashAttention(torch.autograd.Function):
    """Attention of ``[BH, S, D]`` q, k, v with a kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        kernel.check_trainable(q)
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


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
    if torch.is_grad_enabled() and (qt.requires_grad or kt.requires_grad
                                    or vt.requires_grad):
        out = FlashAttention.apply(qt, kt, vt, causal, window)
    else:
        out = flash_attention(qt, kt, vt, causal=causal, window=window)
    return out.reshape(b, hq, sq, d).permute(0, 2, 1, 3)
