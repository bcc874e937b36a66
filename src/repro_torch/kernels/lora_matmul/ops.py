"""Public wrappers around the fused LoRA matmul kernels.

``lora_apply`` and ``lora_apply_grouped`` take any leading dimensions on
``x`` and call the kernels on the ``[M, K]`` view: the CUDA kernel for a
CUDA tensor, its plain version for a CPU tensor.  The grouped wrapper
turns the stacked factors (``a [G, K, r]``, ``b [G, r, N]``) into the
concatenated layout the kernel reads (``A_cat [K, G*r]``, ``B_cat
[G*r, N]``) and hands the per-row adapter index and the scales to the
kernel, which masks its own ragged edges: nothing is padded.

The JAX package's switches between its kernel and its oracle
(``REPRO_GROUPED_LORA_KERNEL``, ``set_grouped_kernel``,
``lora_apply(use_kernel=)``) have no counterpart here: the tensor's device
decides the route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lora_matmul.kernel import (
    lora_matmul,
    lora_matmul_grouped,
)


def lora_apply(
    x: torch.Tensor,            # [..., K]
    w: torch.Tensor,            # [K, N]
    a: torch.Tensor,            # [K, r]
    b: torch.Tensor,            # [r, N]
    scale: float = 1.0,
) -> torch.Tensor:
    """``x @ W + scale * (x @ A) @ B`` over the last axis of ``x``."""
    k, n = w.shape
    out = lora_matmul(x.reshape(-1, k).contiguous(), w.contiguous(),
                      a.contiguous(), b.contiguous(), scale=scale)
    return out.reshape(*x.shape[:-1], n)


def lora_apply_grouped(
    x: torch.Tensor,            # [..., K]
    w: torch.Tensor,            # [K, N]
    a: torch.Tensor,            # [G, K, r]  stacked adapter A factors
    b: torch.Tensor,            # [G, r, N]  stacked adapter B factors
    idx: torch.Tensor,          # [...] adapter per row; -1 = none
    scales: torch.Tensor,       # [G]
) -> torch.Tensor:
    """Batched multi-adapter projection for a batch mixing G tenants:
    ``y = x @ W + scales[idx] * (x @ A[idx]) @ B[idx]`` with per-row
    adapter indices (rows with ``idx < 0`` get the plain projection).

    ``idx`` indexes the leading (row) dimensions of ``x``: one entry per
    row of ``x.reshape(-1, K)``."""
    g, k, r = a.shape
    n = w.shape[1]
    a_cat = a.permute(1, 0, 2).reshape(k, g * r).contiguous()
    b_cat = b.reshape(g * r, n).contiguous()
    out = lora_matmul_grouped(
        x.reshape(-1, k).contiguous(), w.contiguous(), a_cat, b_cat,
        idx.reshape(-1).to(torch.int32).contiguous(),
        scales.to(torch.float32).contiguous())
    return out.reshape(*x.shape[:-1], n)
