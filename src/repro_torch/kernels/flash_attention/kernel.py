"""Flash-attention forward: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``flash_attention`` / ``_attn_kernel``
(``src/repro/kernels/flash_attention/kernel.py``).  The kernel source is
``csrc/flash_attention.cu``; its header note gives the bound at the main
path's shape and what the design does about it.  It is compiled with
``nvcc`` for ``sm_90a`` at first use (:mod:`repro_torch.kernels.build`) and
bound with ``ctypes``.

:func:`flash_attention` takes the plain version (:func:`attention_ref`)
only for tensors on the CPU.  For CUDA tensors it launches the kernel or
raises: there is no fallback.  ``flash_attention.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch.kernels.build import build
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 1024)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fwd: Any = None


def _kernel() -> Any:
    """The bound C entry point (builds the library on first call)."""
    global _fwd
    if _fwd is None:
        fn = ctypes.CDLL(str(build(SOURCE))).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"expected the CUDA device of q ({q.device})")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; the "
                             f"kernel takes float32 or bfloat16, one dtype")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"[BH, S, D] tensor, got {tuple(t.shape)}")
    bh, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")


def flash_attention(
    q: torch.Tensor,            # [BH, Sq, D]
    k: torch.Tensor,            # [BH, Sk, D]
    v: torch.Tensor,            # [BH, Sk, D]
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    _check(q, k, v)
    fwd = _kernel()
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  bh, sq, sk, d, _DTYPE_CODES[q.dtype], scale, int(causal),
                  int(window is not None), int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err} (BH={bh}, Sq={sq}, Sk={sk}, "
                           f"D={d}, {q.dtype})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
