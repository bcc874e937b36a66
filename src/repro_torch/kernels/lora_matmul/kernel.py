"""Fused LoRA matmul: the hand-written CUDA kernel and its two wrappers.

Replaces the Pallas TPU kernels ``lora_matmul`` / ``_lora_kernel`` and
``lora_matmul_grouped`` / ``_lora_kernel_grouped``
(``src/repro/kernels/lora_matmul/kernel.py``).  Both forms are one template
in ``csrc/lora_matmul.cu``: a pre-pass kernel that writes each row's
scaled ``x @ A`` over its own rank block into scratch, then one GEMM of
``[x | xa] @ [W ; B]``, both on the tensor cores in split-precision TF32
with a pass count that follows the operand types (:func:`tf32_passes`).
Its header note gives the bound at the main path's shapes, the tolerance
decision and what the design does about them.  The source is compiled with
``nvcc`` for ``sm_90a`` at first use (:mod:`repro_torch.kernels.build`) and
bound with ``ctypes``.

Each wrapper takes its plain version (:mod:`.ref`) only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises: there is no
fallback.  ``lora_matmul.launches`` and ``lora_matmul_grouped.launches``
count the wrapper calls that launch the kernels (one each).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch.kernels.build import build
from repro_torch.kernels.lora_matmul.ref import (
    lora_matmul_masked_ref,
    lora_matmul_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "lora_matmul.cu"
MAX_RANK_COLS = 256          # G*r the kernels take
XA_ALIGN = 8                 # the scratch's row stride: G*r rounded up to it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (x, W, factors) combinations the source instantiates
_TYPES = {(torch.float32, torch.float32, torch.float32),
          (torch.float32, torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.bfloat16, torch.bfloat16)}

_fwd: Any = None


def tf32_passes(x_dtype: torch.dtype, w_dtype: torch.dtype) -> int:
    """TF32 tensor-core products the kernel runs per product of x and W
    (and of x and the factors, whose type is W's): an f32 operand is cut
    into TF32 hi and lo parts, a bf16 one is exact in TF32.  3 for
    (f32, f32): hi*hi + hi*lo + lo*hi; 2 for (f32, bf16): hi*W + lo*W; 1
    for (bf16, bf16)."""
    return 1 + (x_dtype == torch.float32) + (w_dtype == torch.float32)


def _kernel() -> Any:
    """The bound C entry point (builds the library on first call)."""
    global _fwd
    if _fwd is None:
        fn = ctypes.CDLL(str(build(SOURCE))).lora_matmul_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def _check(name: str, x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor, extra: tuple = ()) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for tn, t in (("x", x), ("w", w), ("a", a), ("b", b)) + extra:
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {tn} on {t.device}, expected the CUDA "
                             f"device of x ({x.device})")
        if t.dim() not in (1, 2) or not t.is_contiguous():
            raise ValueError(f"{name}: {tn} must be contiguous, got shape "
                             f"{tuple(t.shape)}")
    if (x.dtype, w.dtype, a.dtype) not in _TYPES or b.dtype != a.dtype:
        raise ValueError(f"{name}: types x {x.dtype}, w {w.dtype}, a {a.dtype}, "
                         f"b {b.dtype}; the kernel takes (x, w, factors) in "
                         f"{sorted(tuple(str(d) for d in c) for c in _TYPES)}")
    m, k = x.shape
    kr, cols = a.shape
    if w.dim() != 2 or w.shape[0] != k or kr != k or b.shape != (cols, w.shape[1]):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not 0 < cols <= MAX_RANK_COLS:
        raise ValueError(f"{name}: {cols} rank columns; the kernel takes 1 to "
                         f"{MAX_RANK_COLS}")
    if m == 0 or w.shape[1] == 0 or (m + 127) // 128 > 65535:
        raise ValueError(f"{name}: {m} rows, {w.shape[1]} columns; the "
                         f"kernel's grid takes 1 to {65535 * 128} rows and "
                         f"at least one column")


def _launch(x, w, a, b, idx: Optional[torch.Tensor],
            scales: Optional[torch.Tensor], scale: float, g: int, r: int,
            name: str) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    # the pre-pass's x @ A per row, masked and scaled, for the GEMM to read
    xa = torch.empty((m, -(-g * r // XA_ALIGN) * XA_ALIGN), dtype=x.dtype,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            None if idx is None else idx.data_ptr(),
            None if scales is None else scales.data_ptr(), float(scale),
            xa.data_ptr(), out.data_ptr(), m, k, n, g, r,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype],
            _DTYPE_CODES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} (M={m}, K={k}, N={n}, G={g}, r={r}, "
                           f"{x.dtype}/{w.dtype}/{a.dtype})")
    return out


def lora_matmul(
    x: torch.Tensor,            # [M, K]
    w: torch.Tensor,            # [K, N]
    a: torch.Tensor,            # [K, r]
    b: torch.Tensor,            # [r, N]
    *,
    scale: float = 1.0,
) -> torch.Tensor:
    """``x @ W + scale * (x @ A) @ B`` with f32 accumulation, in x's dtype."""
    if x.device.type == "cpu":
        return lora_matmul_ref(x, w, a, b, scale=scale)
    _check("lora_matmul", x, w, a, b)
    out = _launch(x, w, a, b, None, None, scale, 1, a.shape[1], "lora_matmul")
    lora_matmul.launches += 1
    return out


def lora_matmul_grouped(
    x: torch.Tensor,            # [M, K]
    w: torch.Tensor,            # [K, N]
    a_cat: torch.Tensor,        # [K, G*r]  adapters concatenated on rank
    b_cat: torch.Tensor,        # [G*r, N]
    idx: torch.Tensor,          # [M] int32 adapter per row; -1 = none
    scales: torch.Tensor,       # [G] float32
) -> torch.Tensor:
    """``x @ W + ((x @ A_cat) * mask) @ B_cat`` with ``mask[m]`` equal to
    ``scales[idx[m]]`` over row m's adapter rank block and 0 elsewhere; rows
    with ``idx < 0`` are the plain ``x @ W``.  The kernel reads ``idx`` and
    ``scales`` itself; no mask is materialised.

    An index of G or more is the caller's error.  The plain version raises
    ``IndexError`` for it; the kernel cannot raise from the card without a
    synchronisation, so it writes that row as NaN rather than read past
    ``A_cat``.  The port's callers build ``idx`` on the host from the
    batch's own adapter order (``diffusion.ops._multilora_groups``), so
    every index they pass is below G."""
    if x.device.type == "cpu":
        return lora_matmul_masked_ref(x, w, a_cat, b_cat, idx, scales)
    _check("lora_matmul_grouped", x, w, a_cat, b_cat,
           (("idx", idx), ("scales", scales)))
    g = scales.numel()
    if (idx.dtype != torch.int32 or scales.dtype != torch.float32
            or idx.shape != (x.shape[0],) or scales.dim() != 1 or g == 0
            or a_cat.shape[1] % g):
        raise ValueError(f"lora_matmul_grouped: idx {idx.dtype} "
                         f"{tuple(idx.shape)} (int32 [M]), scales "
                         f"{scales.dtype} {tuple(scales.shape)} (float32 [G] "
                         f"dividing {a_cat.shape[1]} rank columns)")
    out = _launch(x, w, a_cat, b_cat, idx, scales, 1.0, g,
                  a_cat.shape[1] // g, "lora_matmul_grouped")
    lora_matmul_grouped.launches += 1
    return out


lora_matmul.launches = 0
lora_matmul_grouped.launches = 0
