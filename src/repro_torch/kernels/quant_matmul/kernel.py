"""w8a8 int8 matmul: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``quant_matmul`` / ``_quant_kernel``
(``src/repro/kernels/quant_matmul/kernel.py``).  ``csrc/quant_matmul.cu``
runs the int8 products on the tensor cores with an int32 accumulator and
applies ``acc * xs[m] * ws[n]`` once per output element; its header note
gives the bound at the path's shapes and the design.  The source is
compiled with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`) and bound with ``ctypes``.

The integer accumulation is exact, so the kernel equals its plain version
(:mod:`.ref`) bit for bit.  The wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``quant_matmul.launches`` counts the kernel launches.  Ragged M, K and N
are masked inside the kernel: nothing is padded.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Any

import torch

from repro_torch.kernels.build import build
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant_matmul.cu"
_BLOCK_M = 128               # rows of one thread block's output tile

_fwd: Any = None


def _kernel() -> Any:
    """The bound C entry point (builds the library on first call)."""
    global _fwd
    if _fwd is None:
        fn = ctypes.CDLL(str(build(SOURCE))).quant_matmul_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def _check(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
           ws: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, t, dtype in (("xq", xq, torch.int8), ("wq", wq, torch.int8),
                           ("xs", xs, torch.float32),
                           ("ws", ws, torch.float32)):
        if t.device != xq.device or t.device.type != "cuda":
            raise ValueError(f"quant_matmul: {name} on {t.device}, expected "
                             f"the CUDA device of xq ({xq.device})")
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be a contiguous 2-D "
                             f"{dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    m, k = xq.shape
    n = wq.shape[1]
    if wq.shape[0] != k or xs.shape != (m, 1) or ws.shape != (1, n):
        raise ValueError(f"quant_matmul: shapes xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}, xs {tuple(xs.shape)}, ws "
                         f"{tuple(ws.shape)}; expected [M, K], [K, N], "
                         f"[M, 1], [1, N]")
    if m == 0 or k == 0 or n == 0 or (m + _BLOCK_M - 1) // _BLOCK_M > 65535:
        raise ValueError(f"quant_matmul: M={m}, K={k}, N={n}; the kernel "
                         f"takes 1 to {65535 * _BLOCK_M} rows and non-empty "
                         f"K and N")


def quant_matmul(
    xq: torch.Tensor,           # [M, K] int8
    wq: torch.Tensor,           # [K, N] int8
    xs: torch.Tensor,           # [M, 1] float32 per-row activation scales
    ws: torch.Tensor,           # [1, N] float32 per-channel weight scales
) -> torch.Tensor:
    """``(xq @ wq) * xs * ws`` with int32 accumulation, float32 ``[M, N]``."""
    if xq.device.type == "cpu":
        return quant_matmul_ref(xq, wq, xs, ws)
    _check(xq, wq, xs, ws)
    m, k = xq.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = _kernel()(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(),
                        ws.data_ptr(), out.data_ptr(), m, k, n, stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul: kernel launch failed with CUDA "
                           f"error {err} (M={m}, K={k}, N={n})")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
