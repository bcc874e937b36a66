"""Plain PyTorch versions of the fused LoRA matmul kernels (f32 math,
output in ``x``'s dtype), in the kernels' own layouts.

The grouped form takes the concatenated factors (``A_cat [K, G*r]``,
``B_cat [G*r, N]``; ``ops.lora_apply_grouped`` lays the stacked factors
out so) and is computed with the per-row mask, never with the JAX
oracle's ``a[idx]`` gather (an ``[M, K, r]`` copy: 1.2 GB at the
full-width MMDiT shape).  Rows with ``idx < 0`` are
``x @ W`` as the port's ``qdense`` computes it, bit for bit: they take no
addition at all.
"""

from __future__ import annotations

import torch


def lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """``x @ W + scale * (x @ A) @ B`` for x ``[M, K]``, W ``[K, N]``,
    A ``[K, r]``, B ``[r, N]``."""
    xf = x.float()
    y = xf @ w.float()
    y = y + scale * ((xf @ a.float()) @ b.float())
    return y.to(x.dtype)


def lora_matmul_masked_ref(
    x: torch.Tensor,            # [M, K]
    w: torch.Tensor,            # [K, N]
    a_cat: torch.Tensor,        # [K, G*r]  adapters concatenated on rank
    b_cat: torch.Tensor,        # [G*r, N]
    idx: torch.Tensor,          # [M] adapter per row; -1 = none
    scales: torch.Tensor,       # [G]
) -> torch.Tensor:
    """``x @ W + ((x @ A_cat) * mask) @ B_cat`` where ``mask[m]`` is
    ``scales[idx[m]]`` over row m's adapter rank block and 0 elsewhere:
    the function the grouped kernel computes, in its own layout."""
    g = scales.numel()
    r = a_cat.shape[1] // g
    idx = idx.reshape(-1).long()
    if idx.numel() and int(idx.max()) >= g:
        raise IndexError(f"adapter index {int(idx.max())} >= G={g}")
    xf = x.float()
    y = xf @ w.float()
    has = idx >= 0
    sel = torch.zeros((idx.numel(), g), dtype=torch.float32, device=x.device)
    sel[has, idx[has]] = scales.float().to(x.device)[idx[has]]
    mask = sel.repeat_interleave(r, dim=1)                  # [M, G*r]
    delta = ((xf @ a_cat.float()) * mask) @ b_cat.float()
    y = torch.where(has[:, None], y + delta, y)
    return y.to(x.dtype)

