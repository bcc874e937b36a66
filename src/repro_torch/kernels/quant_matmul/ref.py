"""Plain PyTorch version of the w8a8 int8 matmul.

``y = (x_q @ w_q) * x_s * w_s`` with an exact integer accumulation.  torch
has no integer matrix product on CUDA, and on the CPU an int8 product
wraps in int8, so the product runs in float64: every partial sum of int8
products is an integer of magnitude at most ``127**2 * K``, exact in
float64 in any order of summation.  The sum is then taken to int32, as the
JAX package's accumulator holds it (exact for K up to 133144), and to
float32, and the two scales multiply in the reference's order.  The result equals the JAX package's
``quant_matmul_ref`` bit for bit.
"""

from __future__ import annotations

import torch


def quant_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                     ws: torch.Tensor) -> torch.Tensor:
    """``[M, K]`` int8 x ``[K, N]`` int8 with ``[M, 1]`` and ``[1, N]``
    float32 scales -> ``[M, N]`` float32."""
    acc = (xq.double() @ wq.double()).to(torch.int32)
    return acc.float() * xs.float() * ws.float()
