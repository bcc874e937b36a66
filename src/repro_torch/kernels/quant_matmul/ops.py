"""Quantize and dequantize helpers and the quantized projection.

A quantized projection weight is a two-leaf dict, as in the JAX package::

    {"qw": int8 | float8_e4m3fn tensor [..., K, N],
     "qs": float32 tensor             [..., 1, N]}   # per output channel

* **int8** is w8a8: symmetric per-channel weight scales, dynamic per-row
  activation scales (:func:`~.kernel.quantize_rows`), and the int8 product
  with int32 accumulation (:func:`~.kernel.quant_matmul`); each the CUDA
  kernel for a CUDA tensor, its plain version for a CPU tensor.
* **fp8** is weight-only storage: the product upcasts the weight to
  float32 and folds the channel scale into the output, a plain product
  outside any kernel, as in the JAX package.

The JAX package quantizes activations in plain ``jnp``; the port's
kernel repeats the plain version's float32 operations.  Every helper
gives the JAX package's bits for the same input (``torch.round`` and
``jnp.round`` both round half to even), the quantized projection those
of its jitted ``quant_apply``.

The JAX package's switches between its kernel and its oracle
(``REPRO_QUANT_KERNEL``, ``set_quant_kernel``, ``quant_kernel_enabled``,
``quant_apply(use_kernel=, block_*=)``) have no counterpart here: the
tensor's device decides the route, and the kernel masks its own ragged
edges, so nothing is padded.
"""

from __future__ import annotations

import itertools
from typing import Any, Tuple

import torch

from repro_torch.kernels.quant_matmul.kernel import quant_matmul, quantize_rows

_INT8_MAX = 127.0
_FP8_MAX = 448.0          # float8_e4m3fn largest finite


def is_quantized(w: Any) -> bool:
    """True iff ``w`` is a quantized ``{"qw", "qs"}`` weight."""
    return isinstance(w, dict) and set(w.keys()) == {"qw", "qs"}


def quantize_weight(w: Any, mode: str) -> dict:
    """Quantize a dense projection weight ``[..., K, N]`` (possibly
    layer-stacked), symmetric per output channel along the last axis.
    A weight that is quantized already comes back as it is.

    A stacked ``[L, ..., K, N]`` leaf is quantized one ``[K, N]`` matrix at
    a time into preallocated outputs: the channel amax runs over K within
    each matrix, so the bits are the whole leaf's, and the float32
    temporaries are one matrix's (at Flux's width, 226 MB for a layer of
    ``ada`` where the whole leaf took 12.9 GB, two or three at once)."""
    if is_quantized(w):
        return w
    if w.dim() <= 2:
        return _quantize_matrix(w, mode)
    lead = w.shape[:-2]
    first = _quantize_matrix(w[(0,) * len(lead)], mode)
    qw = first["qw"].new_empty(lead + first["qw"].shape)
    qs = first["qs"].new_empty(lead + first["qs"].shape)
    for idx in itertools.product(*map(range, lead)):
        q = first if not any(idx) else _quantize_matrix(w[idx], mode)
        qw[idx], qs[idx] = q["qw"], q["qs"]
    return {"qw": qw, "qs": qs}


def _quantize_matrix(w: torch.Tensor, mode: str) -> dict:
    """:func:`quantize_weight` of one ``[K, N]`` matrix (or a vector)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)                # [..., 1, N]
    if mode == "int8":
        qs = torch.where(amax > 0, amax / _INT8_MAX, 1.0)
        qw = torch.clamp(torch.round(wf / qs), -_INT8_MAX, _INT8_MAX)
        qw = qw.to(torch.int8)
    elif mode == "fp8":
        qs = torch.where(amax > 0, amax / _FP8_MAX, 1.0)
        qw = (wf / qs).to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quant mode {mode!r}")
    return {"qw": qw, "qs": qs.float()}


def dequantize_weight(q: Any) -> Any:
    """The float32 weight ``[..., K, N]`` a quantized dict stands for (the
    grouped LoRA route needs the dense base); anything else as it is."""
    if not is_quantized(q):
        return q
    return q["qw"].float() * q["qs"]


def _quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 activation quantization: ``[M, K]`` float32 ->
    (int8 values, ``[M, 1]`` float32 scales); the CUDA kernel for a CUDA
    tensor, its plain version (``ref.quantize_rows_ref``) for a CPU one."""
    return quantize_rows(x2.contiguous())


def quant_apply(x: torch.Tensor, qw: torch.Tensor,
                qs: torch.Tensor) -> torch.Tensor:
    """The projection ``x @ dequant(qw, qs)`` on the quantized route, over
    the last axis of ``x``; float32 out.  int8 weights take the w8a8
    product, fp8 weights the upcast product with the scale folded into the
    output.  A layer slice ``[1, K, N]`` / ``[1, 1, N]`` is taken too."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = qw.shape[-1]
    qw2 = qw.reshape(k, n)
    ws = qs.reshape(1, n)
    x2 = x.float().reshape(-1, k)
    if qw2.dtype != torch.int8:
        out = (x2 @ qw2.float()) * ws
        return out.reshape(*lead, n)
    xq, xs = _quantize_rows(x2)
    out = quant_matmul(xq, qw2.contiguous(), xs, ws.contiguous())
    return out.reshape(*lead, n)
