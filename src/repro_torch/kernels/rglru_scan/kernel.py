"""RG-LRU scan: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``rglru_scan`` / ``_rglru_kernel``
(``src/repro/kernels/rglru_scan/kernel.py``).  ``csrc/rglru_scan.cu`` runs
one thread per (batch, channel) through the whole sequence; its header
note gives the bound and the design.  The source is compiled with ``nvcc``
for ``sm_90a`` at first use (:mod:`repro_torch.kernels.build`) and bound
with ``ctypes``.

The wrapper takes the plain version (:mod:`.ref`) only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
``rglru_scan.launches`` counts the kernel launches.  The kernel takes any
T and D: nothing is padded.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Any

import torch

from repro_torch.kernels.build import build
from repro_torch.kernels.rglru_scan.ref import rglru_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"

_fwd: Any = None


def _kernel() -> Any:
    """The bound C entry point (builds the library on first call)."""
    global _fwd
    if _fwd is None:
        fn = ctypes.CDLL(str(build(SOURCE))).rglru_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t`` over the time
    axis of ``[B, T, D]`` inputs, ``h_{-1} = 0``."""
    if a.device.type == "cpu":
        return rglru_ref(a, x)
    for name, t in (("a", a), ("x", x)):
        if t.device != a.device or t.device.type != "cuda":
            raise ValueError(f"rglru_scan: {name} on {t.device}, expected the "
                             f"CUDA device of a ({a.device})")
        if (t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous()
                or t.shape != a.shape):
            raise ValueError(f"rglru_scan: a and x must be contiguous float32 "
                             f"[B, T, D] tensors of one shape, got {name} "
                             f"{t.dtype} {tuple(t.shape)}")
    b, t_len, d = a.shape
    if min(b, t_len, d) == 0 or b > 65535:
        raise ValueError(f"rglru_scan: shape {tuple(a.shape)}; the kernel "
                         f"takes 1 to 65535 batch rows and non-empty T and D")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel()(a.data_ptr(), x.data_ptr(), out.data_ptr(), b, t_len,
                        d, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA error "
                           f"{err} (B={b}, T={t_len}, D={d})")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
