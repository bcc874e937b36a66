"""Plain PyTorch versions of the w8a8 int8 matmul and of the per-row
activation quantization that feeds it.

``y = (x_q @ w_q) * x_s * w_s`` with an exact integer accumulation.  torch
has no integer matrix product on CUDA, and on the CPU an int8 product
wraps in int8, so the product runs in float64: every partial sum of int8
products is an integer of magnitude at most ``127**2 * K``, exact in
float64 in any order of summation.  The sum is then taken to int32, as the
JAX package's accumulator holds it (exact for K up to 133144), and to
float32, and the two scales multiply in the reference's order.  The result equals the JAX package's
``quant_matmul_ref`` bit for bit.

``quantize_rows_ref`` is the dynamic per-row activation quantization, bit
for bit the JAX package's ``_quantize_rows`` as it runs inside its jitted
``_quant_apply``: there XLA computes the row scale ``amax / 127`` as a
product with the float32 reciprocal, and so does this version
(``torch.round`` and ``jnp.round`` both round half to even).
"""

from __future__ import annotations

import torch

_INT8_MAX = 127.0
# 1/127 rounded to float32.  The JAX package quantizes activations inside
# jit, where XLA turns the division by the constant 127 into a product with
# this reciprocal; the port multiplies too, to give the same scales.
_INV_INT8_MAX = 0.007874015718698502


def quant_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                     ws: torch.Tensor) -> torch.Tensor:
    """``[M, K]`` int8 x ``[K, N]`` int8 with ``[M, 1]`` and ``[1, N]``
    float32 scales -> ``[M, N]`` float32."""
    acc = (xq.double() @ wq.double()).to(torch.int32)
    return acc.float() * xs.float() * ws.float()


def quantize_rows_ref(x2: torch.Tensor) -> tuple:
    """Dynamic per-row int8 activation quantization: ``[M, K]`` float32 ->
    (int8 values ``[M, K]``, ``[M, 1]`` float32 scales); a zero row gets
    scale 1."""
    amax = x2.abs().amax(dim=-1, keepdim=True)                # [M, 1]
    xs = torch.where(amax > 0, amax * _INV_INT8_MAX, 1.0)
    xq = torch.clamp(torch.round(x2 / xs), -_INT8_MAX, _INT8_MAX)
    return xq.to(torch.int8), xs.float()
