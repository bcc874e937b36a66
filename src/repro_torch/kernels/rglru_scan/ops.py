"""Public wrapper around the RG-LRU scan kernel.

``rglru(a, x)`` calls :func:`~.kernel.rglru_scan` on contiguous views: the
CUDA kernel for a CUDA tensor, its plain version for a CPU tensor.  The
JAX package's tiling and route arguments (``block_t``, ``block_d``,
``use_kernel``) have no counterpart: the tensor's device decides the
route, and the kernel needs no padding.  The hybrid LLM family
(:func:`repro_torch.models.hybrid.rglru_block`) calls it once per RG-LRU
block, where the JAX package's hybrid calls the oracle.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.kernel import rglru_scan


def rglru(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[B, T, D]`` decay gates ``a`` in (0, 1) and inputs ``x`` ->
    ``[B, T, D]`` recurrent states."""
    return rglru_scan(a.contiguous(), x.contiguous())
