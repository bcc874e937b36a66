"""RG-LRU scan: the hand-written CUDA kernels (forward and backward) and
their wrappers.

Replaces the Pallas TPU kernel ``rglru_scan`` / ``_rglru_kernel``
(``src/repro/kernels/rglru_scan/kernel.py``).  ``csrc/rglru_scan.cu`` is a
single-pass scan split over time as well as over (batch, channel): tiles
of 32 channels by 256 steps, reduced and rescanned in registers, the carry
chained across tiles by decoupled look-back; its header note gives the
bound and the design.  The source is compiled with ``nvcc`` for ``sm_90a``
at first use (:mod:`repro_torch.kernels.build`) and bound with ``ctypes``.

The wrapper takes the plain version (:mod:`.ref`) only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  A call allocates
the look-back's workspace with ``torch.empty`` on the current stream and
launches two CUDA kernels (``rglru_scan_init_kernel``, then
``rglru_scan_kernel``); ``rglru_scan.launches`` counts one launch a call.
The kernel takes any T and D: nothing is padded.

:func:`rglru_scan_bwd` is the backward, ``(da, dx)`` from the forward's
inputs and output and the upstream gradient: the same source's
``rglru_scan_bwd_kernel`` (the forward's look-back run backwards in time,
the same bits every call; an init kernel before it, one launch counted in
``rglru_scan_bwd.launches``) for CUDA tensors, :func:`rglru_bwd_ref` for
CPU ones.  It replaces no Pallas kernel: the JAX package's hybrid
differentiates the scan's oracle.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Any

import torch

from repro_torch.kernels import meta
from repro_torch.kernels.build import build
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"

_fwd: Any = None


def _kernel() -> Any:
    """The bound C entry point (builds the library on first call)."""
    global _fwd
    if _fwd is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        fn = lib.rglru_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size = lib.rglru_scan_workspace
        size.argtypes = [ctypes.c_int] * 3
        size.restype = ctypes.c_longlong
        fn.workspace = functools.lru_cache(maxsize=64)(size)
        bwd = lib.rglru_scan_bwd
        bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        fn.bwd = bwd
        _fwd = fn
    return _fwd


def _refuse(a: torch.Tensor, *others: torch.Tensor,
            names: str = "ax") -> None:
    for name, t in zip(names, (a, *others)):
        if t.device != a.device or t.device.type != "cuda":
            raise ValueError(f"rglru_scan: {name} on {t.device}, expected the "
                             f"CUDA device of a ({a.device})")
        if (t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous()
                or t.shape != a.shape):
            raise ValueError(f"rglru_scan: {', '.join(names)} must be "
                             f"contiguous float32 [B, T, D] tensors of one "
                             f"shape, got {name} "
                             f"{t.dtype} {tuple(t.shape)}")
    raise ValueError(f"rglru_scan: shape {tuple(a.shape)}; the kernel takes 1 "
                     f"to 65535 batch rows and non-empty T and D")


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t`` over the time
    axis of ``[B, T, D]`` inputs, ``h_{-1} = 0``.  Meta tensors take the
    dry run's meta route (:mod:`repro_torch.kernels.meta`)."""
    if a.device.type == "meta":
        return meta.rglru_scan(a, x)
    if a.device.type == "cpu":
        return rglru_ref(a, x)
    # one test on the usual path; the host time of a call shows beside a
    # 0.1 ms kernel
    if not (a.is_cuda and x.device == a.device and a.dtype == torch.float32
            and x.dtype == torch.float32 and a.dim() == 3
            and x.shape == a.shape and a.is_contiguous()
            and x.is_contiguous() and 0 < a.shape[0] <= 65535
            and a.numel() > 0):
        _refuse(a, x)
    b, t_len, d = a.shape
    fwd = _kernel()
    dev = a.device.index
    out = torch.empty_like(a)
    # the tile counter and the look-back's states and pairs
    ws = torch.empty(fwd.workspace(b, t_len, d), dtype=torch.uint8,
                     device=a.device)
    err = fwd(a.data_ptr(), x.data_ptr(), out.data_ptr(), ws.data_ptr(), b,
              t_len, d, dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA error "
                           f"{err} (B={b}, T={t_len}, D={d})")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0


def rglru_scan_bwd(a: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor) -> tuple:
    """``(da, dx)`` of :func:`rglru_scan` at ``(a, x)``, given its output
    ``h`` and the upstream gradient ``dh`` (all ``[B, T, D]``)."""
    if a.device.type == "meta":
        return meta.rglru_scan_bwd(a, x, h, dh)
    if a.device.type == "cpu":
        return rglru_bwd_ref(a, x, h, dh)
    ins = (a, x, h, dh)
    if not (a.is_cuda and a.dim() == 3 and 0 < a.shape[0] <= 65535
            and a.numel() > 0
            and all(t.device == a.device and t.dtype == torch.float32
                    and t.shape == a.shape and t.is_contiguous()
                    for t in ins)):
        _refuse(*ins, names=("a", "x", "h", "dh"))
    b, t_len, d = a.shape
    fwd = _kernel()
    dev = a.device.index
    da, dx = torch.empty_like(a), torch.empty_like(x)
    ws = torch.empty(fwd.workspace(b, t_len, d), dtype=torch.uint8,
                     device=a.device)
    err = fwd.bwd(a.data_ptr(), x.data_ptr(), h.data_ptr(), dh.data_ptr(),
                  da.data_ptr(), dx.data_ptr(), ws.data_ptr(), b, t_len, d,
                  dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd: kernel launch failed with CUDA "
                           f"error {err} (B={b}, T={t_len}, D={d})")
    rglru_scan_bwd.launches += 1
    return da, dx


rglru_scan_bwd.launches = 0
