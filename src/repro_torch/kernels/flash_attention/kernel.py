"""Flash attention: the hand-written CUDA kernels (forward and backward)
and their wrappers.

Replaces the Pallas TPU kernel ``flash_attention`` / ``_attn_kernel``
(``src/repro/kernels/flash_attention/kernel.py``).  The kernel source is
``csrc/flash_attention.cu``; its header note gives the bound at the main
path's shape and what the design does about it.  It is compiled with
``nvcc`` for ``sm_90a`` at first use (:mod:`repro_torch.kernels.build`) and
bound with ``ctypes``.  The source routes by shape: f32 at head dim 64 to
split-precision TF32 ``mma.sync`` tiles; f32 at head dim 128 (Flux's
heads) to a pre-pass that splits K and V once into TF32 hi/lo planes laid
out as shared memory holds them (:func:`split_planes`), then a
warp-specialised kernel whose producer warpgroup copies the planes tile by
tile with TMA bulk copies and whose two consumer warpgroups run
split-TF32 ``wgmma`` products, each chain of sums at most 8 k steps (the
source's header note gives the bound, the chain structure with its
emulated margin, and the times); f32 at head dim 1024 to a split-KV grid
and a merge kernel; the rest (head dims 8, 16 and 32, and bf16 at every
head dim) to a CUDA-core template.  The wrapper allocates each route's
scratch (the planes, the split-KV partials).  Head dims:
``SUPPORTED_HEAD_DIMS``.

:func:`flash_attention` takes the plain version (:func:`attention_ref`)
only for tensors on the CPU.  For CUDA tensors it launches the kernels or
raises: there is no fallback.  ``flash_attention.launches`` counts the
wrapper's launches, one a call whatever number of CUDA kernels it runs.
With ``return_lse=True`` (f32 at head dims 8-64, the training routes) the
forward also returns each row's log-sum-exp, which the backward needs.

:func:`flash_attention_bwd` is the backward: ``csrc/flash_attention_bwd.cu``
(a row-sum pre-pass, then a dK/dV sweep per key tile and a dQ sweep per
query tile, at head dim 64 in one grid on split-TF32 tensor-core tiles,
the same bits every call; its header note gives the bound and the design)
for CUDA tensors, :func:`attention_bwd_ref` for CPU ones.
It replaces no Pallas kernel (the JAX package differentiates its plain
attention); ``flash_attention_bwd.launches`` counts its calls.  The
``torch.autograd.Function`` that joins the two is in :mod:`.ops`.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch.kernels import meta
from repro_torch.kernels.build import build
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_partial_ref,
    attention_ref,
    merge_partials_ref,
    split_planes_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128, 1024)
BWD_HEAD_DIMS = (8, 16, 32, 64)  # the backward: f32 at these head dims
SPLIT_KV_HEAD_DIM = 1024        # f32 at this head dim takes the split-KV route
SPLIT_KV_CHUNK = 64             # keys per split-KV block
D128_TILE = 32                  # keys a tile of the head-dim-128 split planes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT, _PTR = ctypes.c_int, ctypes.c_void_p

_lib: Any = None
_bwd_lib: Any = None


def _kernel() -> Any:
    """The bound C library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        for name, args, res in (
                ("flash_attention_fwd", [_PTR] * 5 + [_INT] * 5
                 + [ctypes.c_float] + [_INT] * 3 + [_PTR] * 2, _INT),
                ("flash_attention_scratch_floats", [_INT] * 5,
                 ctypes.c_longlong),
                ("flash_attention_split_kv_chunk", [], _INT),
                ("flash_attention_partials", [_PTR] * 4 + [_INT] * 3
                 + [ctypes.c_float] + [_INT] * 3 + [_PTR], _INT),
                ("flash_attention_merge", [_PTR] * 2 + [_INT] * 3 + [_PTR],
                 _INT),
                ("flash_attention_d128_tile", [], _INT),
                ("flash_attention_split128", [_PTR] * 3 + [_INT] * 2 + [_PTR],
                 _INT)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        if lib.flash_attention_split_kv_chunk() != SPLIT_KV_CHUNK:
            raise RuntimeError("flash_attention: the built library's split-KV "
                               "chunk differs from SPLIT_KV_CHUNK")
        if lib.flash_attention_d128_tile() != D128_TILE:
            raise RuntimeError("flash_attention: the built library's head-"
                               "dim-128 tile differs from D128_TILE")
        _lib = lib
    return _lib


def _bwd_kernel() -> Any:
    """The bound backward entry point (built on first call)."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = ctypes.CDLL(str(build(BWD_SOURCE)))
        fn = lib.flash_attention_bwd
        fn.argtypes = ([_PTR] * 10 + [_INT] * 4 + [ctypes.c_float]
                       + [_INT] * 3 + [_PTR])
        fn.restype = _INT
        _bwd_lib = fn
    return _bwd_lib


def check_trainable(q: torch.Tensor) -> None:
    """Raise unless the backward kernel takes ``q``'s dtype and head dim:
    f32 at head dims 8-64.  Head dims 128 and 1024 and bf16 have no
    backward kernel; no training path reaches them."""
    if q.device.type == "cuda" and (q.dtype != torch.float32
                                    or q.shape[-1] not in BWD_HEAD_DIMS):
        raise ValueError(f"flash_attention: no backward kernel for "
                         f"{q.dtype} at head dim {q.shape[-1]}; it takes "
                         f"float32 at head dims {BWD_HEAD_DIMS}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention: {what}: kernel launch failed "
                           f"with CUDA error {err}")


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
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (the kernels copy 16-byte chunks)")
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
    return_lse: bool = False,
) -> Any:
    """Attention of ``[BH, S, D]`` q, k, v; with ``return_lse`` the pair
    ``(out, lse)``, ``lse`` [BH, Sq] f32 each row's log-sum-exp of the
    scaled, masked scores (+inf for a row that sees no key).  Meta tensors
    take the dry run's meta route (:mod:`repro_torch.kernels.meta`)."""
    if q.device.type == "meta":
        return meta.flash_attention(q, k, v, return_lse=return_lse)
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, causal=causal, window=window,
                            scale=scale)
        if not return_lse:
            return out
        return out, attention_lse_ref(q, k, causal=causal, window=window,
                                      scale=scale)
    _check(q, k, v)
    if return_lse:
        check_trainable(q)
    lib = _kernel()
    bh, sq, d = q.shape
    sk = k.shape[1]
    dtype = _DTYPE_CODES[q.dtype]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    # the split-KV route's partial outputs, row maxima and row sums
    n = lib.flash_attention_scratch_floats(bh, sq, sk, d, dtype)
    scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if n else None, bh, sq, sk, d, dtype, scale,
            int(causal), int(window is not None), int(window or 0),
            lse.data_ptr() if return_lse else None,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, f"BH={bh}, Sq={sq}, Sk={sk}, D={d}, {q.dtype}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,            # [BH, Sq, D]
    k: torch.Tensor,            # [BH, Sk, D]
    v: torch.Tensor,            # [BH, Sk, D]
    o: torch.Tensor,            # [BH, Sq, D], the forward's output
    lse: torch.Tensor,          # [BH, Sq] f32, the forward's row log-sum-exp
    do: torch.Tensor,           # [BH, Sq, D], the output's gradient
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> tuple:
    """``(dq, dk, dv)`` of :func:`flash_attention` (f32, head dims 8-64)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "meta":
        return meta.flash_attention_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, scale, causal=causal,
                                 window=window)
    _check(q, k, v)
    check_trainable(q)
    bh, sq, d = q.shape
    sk = k.shape[1]
    for name, t, shape in (("o", o, q.shape), ("do", do, q.shape),
                           ("lse", lse, (bh, sq))):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous, 16-byte aligned float32 "
                             f"{tuple(shape)} tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    fn = _bwd_kernel()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d,
                 scale, int(causal), int(window is not None),
                 int(window or 0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, f"backward BH={bh}, Sq={sq}, Sk={sk}, D={d}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# The split-KV route's two passes on their own, so that each kernel can be
# held against its plain version; ``flash_attention`` runs both in one call.

def split_kv_partials(
    q: torch.Tensor,            # [BH, Sq, 1024] f32
    k: torch.Tensor,            # [BH, Sk, 1024] f32
    v: torch.Tensor,            # [BH, Sk, 1024] f32
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> tuple:
    """Per-chunk partials ``(o, m, l)`` of :func:`attention_partial_ref`
    (chunks of ``SPLIT_KV_CHUNK`` keys) from the split-KV kernel."""
    if q.device.type == "cpu":
        return attention_partial_ref(q, k, v, chunk=SPLIT_KV_CHUNK,
                                     causal=causal, window=window, scale=scale)
    _check(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.dtype != torch.float32 or d != SPLIT_KV_HEAD_DIM:
        raise ValueError(f"split_kv_partials: the split-KV route takes f32 "
                         f"at head dim {SPLIT_KV_HEAD_DIM}, got {q.dtype}, {d}")
    lib = _kernel()
    o, m, l, scratch = _partials_views(bh, sq, sk, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_partials(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), scratch.data_ptr(), bh,
            sq, sk, scale, int(causal), int(window is not None),
            int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "split-KV partials")
    return o, m, l


def split_kv_merge(o: torch.Tensor, m: torch.Tensor,
                   l: torch.Tensor) -> torch.Tensor:
    """:func:`merge_partials_ref` by the merge kernel: partials of
    ``ceil(Sk / SPLIT_KV_CHUNK)`` chunks, [C, BH, Sq, 1024] f32."""
    if o.device.type == "cpu":
        return merge_partials_ref(o, m, l)
    c, bh, sq, d = o.shape
    if (d != SPLIT_KV_HEAD_DIM or o.dtype != torch.float32
            or m.shape != (c, bh, sq) or l.shape != (c, bh, sq)):
        raise ValueError(f"split_kv_merge: partials {tuple(o.shape)} "
                         f"{o.dtype}, m {tuple(m.shape)}, l {tuple(l.shape)}")
    lib = _kernel()
    sk = c * SPLIT_KV_CHUNK
    po, pm, pl, scratch = _partials_views(bh, sq, sk, o.device)
    po.copy_(o)
    pm.copy_(m)
    pl.copy_(l)
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = lib.flash_attention_merge(
            scratch.data_ptr(), out.data_ptr(), bh, sq, sk,
            torch.cuda.current_stream(o.device).cuda_stream)
    _raise_on(err, "split-KV merge")
    return out


def _partials_views(bh: int, sq: int, sk: int, device) -> tuple:
    """A scratch in the kernels' layout and its (o, m, l) views."""
    c = -(-sk // SPLIT_KV_CHUNK)
    d = SPLIT_KV_HEAD_DIM
    scratch = torch.empty(c * bh * sq * (d + 2), dtype=torch.float32,
                          device=device)
    n = c * bh * sq
    return (scratch[:n * d].view(c, bh, sq, d),
            scratch[n * d:n * (d + 1)].view(c, bh, sq),
            scratch[n * (d + 1):].view(c, bh, sq), scratch)


def split_planes(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The f32 head-dim-128 route's pre-pass on its own, so that it can be
    held against its plain version: :func:`split_planes_ref`'s planes of
    ``[BH, Sk, 128]`` k and v, ``[BH, ceil(Sk / D128_TILE), 4, D128_TILE *
    128]`` f32, from the pre-pass kernel (``flash_attention`` runs it before
    the main kernel on every call)."""
    if k.device.type == "cpu":
        return split_planes_ref(k, v, tile=D128_TILE)
    _check(k, k, v)
    bh, sk, d = k.shape
    if k.dtype != torch.float32 or d != 128:
        raise ValueError(f"split_planes: the head-dim-128 route takes f32 at "
                         f"head dim 128, got {k.dtype}, {d}")
    lib = _kernel()
    n = lib.flash_attention_scratch_floats(bh, 1, sk, d, 0)
    planes = torch.empty(n, dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        err = lib.flash_attention_split128(
            k.data_ptr(), v.data_ptr(), planes.data_ptr(), bh, sk,
            torch.cuda.current_stream(k.device).cuda_stream)
    _raise_on(err, "head-dim-128 split planes")
    return planes.view(bh, -1, 4, D128_TILE * 128)
