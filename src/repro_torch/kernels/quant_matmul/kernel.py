"""w8a8 int8 matmul and per-row activation quantization: the hand-written
CUDA kernels and their wrappers.

``csrc/quant_matmul.cu`` replaces the Pallas TPU kernel ``quant_matmul`` /
``_quant_kernel`` (``src/repro/kernels/quant_matmul/kernel.py``): the int8
products on the tensor cores with an int32 accumulator, then
``acc * xs[m] * ws[n]`` once per output element.  ``csrc/quantize_rows.cu``
replaces the plain activation quantization that the JAX package's
``_quant_apply`` runs before its kernel.  Each header note gives the bound
at the path's shapes and the design.  The sources are compiled with
``nvcc`` for ``sm_90a`` at first use (:mod:`repro_torch.kernels.build`) and
bound with ``ctypes``.

Both kernels equal their plain versions (:mod:`.ref`) bit for bit: the
integer accumulation is exact, and the quantization repeats the plain
version's float32 operations.  Each wrapper takes its plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel or raises.
``quant_matmul.launches`` and ``quantize_rows.launches`` count the wrapper
calls that launch (a split-K product is two kernels and counts one).
:func:`plan` picks the product's tiles and split from its shape; ragged M,
K and N are masked inside the kernel, so nothing is padded.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Any, Tuple

import torch

from repro_torch.kernels.build import build
from repro_torch.kernels.quant_matmul.ref import (
    quant_matmul_ref,
    quantize_rows_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant_matmul.cu"
ROWS_SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize_rows.cu"
BLOCK_N = 128                # columns of an output tile, every route
BLOCK_K = 128                # K step of the cp.async ring, bytes
ROUTE_ROWS = (128, 64, 16)   # rows of an output tile: large, mid, small M
SMALL_M = 64                 # at most this many rows take the small route
MIN_SPLIT_STEPS = 2          # K steps a split keeps at least

_fns: dict = {}


def _bind(source: Path, name: str, n_ptrs: int, n_ints: int) -> Any:
    """The C entry point ``name`` of ``source`` (builds the library on first
    call): ``n_ptrs`` pointers, ``n_ints`` ints, then the stream."""
    if name not in _fns:
        fn = getattr(ctypes.CDLL(str(build(source))), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(m: int, k: int, n: int, sms: int) -> Tuple[int, int]:
    """(route, splits) of an ``[M, K] x [K, N]`` product on a card with
    ``sms`` SMs.  Route 0 (128-row tiles) when its grid fills two blocks an
    SM, route 2 (16-row tiles, streaming wq) for M <= 64, route 1 (64-row
    tiles) between.  A grid under two blocks an SM splits K towards that,
    each split keeping at least ``MIN_SPLIT_STEPS`` steps of ``BLOCK_K``; as
    each split writes and reads back an int32 ``[M, N]``, only as far as
    those bytes stay within half the operands' (xq and wq)."""
    tiles_n = -(-n // BLOCK_N)
    if m <= SMALL_M:
        route = 2
    elif -(-m // ROUTE_ROWS[0]) * tiles_n >= 2 * sms:
        route = 0
    else:
        route = 1
    blocks = -(-m // ROUTE_ROWS[route]) * tiles_n
    steps = -(-k // BLOCK_K)
    splits = 1
    if blocks < 2 * sms:
        want = min(-(-2 * sms // blocks), steps // MIN_SPLIT_STEPS,
                   (m * k + k * n) // (16 * m * n))
        if want > 1:
            splits = -(-steps // -(-steps // want))   # no empty split
    return route, splits


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
    rows = ROUTE_ROWS[0]
    if m == 0 or k == 0 or n == 0 or (m + rows - 1) // rows > 65535:
        raise ValueError(f"quant_matmul: M={m}, K={k}, N={n}; the kernel "
                         f"takes 1 to {65535 * rows} rows and non-empty "
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
    with torch.cuda.device(xq.device):
        route, splits = plan(m, k, n, _sm_count(torch.cuda.current_device()))
        out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
        part = (torch.empty((splits, m, n), dtype=torch.int32,
                            device=xq.device) if splits > 1 else None)
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = _bind(SOURCE, "quant_matmul_fwd", 6, 5)(
            xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            m, k, n, route, splits, stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul: kernel launch failed with CUDA "
                           f"error {err} (M={m}, K={k}, N={n}, route {route}, "
                           f"{splits} splits)")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 activation quantization: ``[M, K]`` float32 ->
    (int8 values ``[M, K]``, ``[M, 1]`` float32 scales)."""
    if x2.device.type == "cpu":
        return quantize_rows_ref(x2)
    if (x2.device.type != "cuda" or x2.dtype != torch.float32
            or x2.dim() != 2 or not x2.is_contiguous()):
        raise ValueError(f"quantize_rows: x must be a contiguous 2-D float32 "
                         f"CUDA tensor, got {x2.dtype} {tuple(x2.shape)} on "
                         f"{x2.device}")
    m, k = x2.shape
    if m == 0 or k == 0:
        raise ValueError(f"quantize_rows: M={m}, K={k}; the kernel takes "
                         f"non-empty rows")
    xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = _bind(ROWS_SOURCE, "quantize_rows_fwd", 3, 2)(
            x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k, stream)
    if err != 0:
        raise RuntimeError(f"quantize_rows: kernel launch failed with CUDA "
                           f"error {err} (M={m}, K={k})")
    quantize_rows.launches += 1
    return xq, xs


quantize_rows.launches = 0
