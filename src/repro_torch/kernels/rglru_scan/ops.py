"""Public wrapper around the RG-LRU scan kernels.

``rglru(a, x)`` calls :func:`~.kernel.rglru_scan` on contiguous views: the
CUDA kernel for a CUDA tensor, its plain version for a CPU tensor.  The
JAX package's tiling and route arguments (``block_t``, ``block_d``,
``use_kernel``) have no counterpart: the tensor's device decides the
route, and the kernel needs no padding.  The hybrid LLM family
(:func:`repro_torch.models.hybrid.rglru_block`) calls it once per RG-LRU
block, where the JAX package's hybrid calls the oracle.

Where autograd needs a gradient (grad enabled and an input that requires
one), the call goes through :class:`RGLRUScan`, a
``torch.autograd.Function`` whose forward is the same scan and whose
backward is :func:`~.kernel.rglru_scan_bwd`: the backward kernel on the
card, which it launches or raises (it never differentiates the plain
version there), the plain backward on the CPU.  Meta tensors (the dry
run) take the kernels' meta routes, and ``DTensor`` inputs run on their
local shards (:func:`repro_torch.kernels.meta.on_local_shards`), batch and
channels split and time whole.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import meta
from repro_torch.kernels.rglru_scan.kernel import rglru_scan, rglru_scan_bwd


class RGLRUScan(torch.autograd.Function):
    """The scan over ``[B, T, D]`` gates and inputs with a kernel backward."""

    @staticmethod
    def forward(ctx, a, x):
        h = rglru_scan(a, x)
        ctx.save_for_backward(a, x, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, x, h = ctx.saved_tensors
        return rglru_scan_bwd(a, x, h, dh.contiguous())


def rglru(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[B, T, D]`` decay gates ``a`` in (0, 1) and inputs ``x`` ->
    ``[B, T, D]`` recurrent states."""
    if meta.is_dtensor(a) or meta.is_dtensor(x):   # a dry-run trace
        return meta.on_local_shards(rglru, (a, x), (0, 2))
    a, x = a.contiguous(), x.contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad):
        return RGLRUScan.apply(a, x)
    return rglru_scan(a, x)
