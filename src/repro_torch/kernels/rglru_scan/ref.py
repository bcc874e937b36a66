"""Plain PyTorch versions of the RG-LRU scan and its backward.  The scan
in the JAX package's formulation: ``h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t`` as a
log-depth associative scan over time of the pairs ``(a_t, gated x_t)``
under ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``, with the odd/even
recursion of ``jax.lax.associative_scan``.  Elementwise float32 throughout;
the output is in ``x``'s dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def _combine(c1: Pair, c2: Pair) -> Pair:
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, b1 * a2 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even`` at the even time steps, ``odd`` at the odd ones."""
    shape = list(even.shape)
    shape[1] += odd.shape[1]
    out = even.new_empty(shape)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """The inclusive associative scan over axis 1 of the pairs ``(a_t, b_t)``
    under :func:`_combine`: ``jax.lax.associative_scan``'s recursion, also
    the port's sLSTM scan."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, scan the half-length sequence recursively
    odd = linear_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                          (a[:, 1::2], b[:, 1::2])))
    head = odd if n % 2 else (odd[0][:, :-1], odd[1][:, :-1])
    even = _combine(head, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], 1),
            torch.cat([b[:, :1], even[1]], 1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def rglru_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[B, T, D]`` decay gates and inputs -> ``[B, T, D]`` states."""
    af = a.float()
    xf = x.float() * torch.sqrt(torch.clamp(1.0 - af * af, min=0.0))
    _, h = linear_scan(af, xf)
    return h.to(x.dtype)


def rglru_bwd_ref(a: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                  dh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(da, dx)`` of :func:`rglru_ref` at ``(a, x)`` with output ``h``
    and upstream gradient ``dh``, all ``[B, T, D]``: the reverse-time scan
    ``g_t = dh_t + a_{t+1} g_{t+1}`` (:func:`linear_scan` over the flipped
    time axis, the coefficients shifted by one step), then
    ``dx_t = g_t sqrt(max(1 - a_t^2, 0))`` and
    ``da_t = g_t (h_{t-1} + x_t d sqrt(max(1 - a_t^2, 0)) / da_t)`` with
    ``h_{-1} = 0``, the derivative ``-a_t / sqrt(1 - a_t^2)`` where
    ``1 - a_t^2 > 0`` and 0 elsewhere (the max's side): what
    ``jax.vjp(rglru_ref)`` computes.  float32; the results in ``a``'s and
    ``x``'s dtypes."""
    af, xf, hf, gf = a.float(), x.float(), h.float(), dh.float()
    # g over reversed time: G_s = A_s G_{s-1} + dh_{T-1-s}, A_s = a_{T-s}
    coef = torch.cat([torch.zeros_like(af[:, :1]), af[:, 1:].flip(1)], 1)
    _, g = linear_scan(coef, gf.flip(1))
    g = g.flip(1)
    y = 1.0 - af * af
    root = torch.sqrt(torch.clamp(y, min=0.0))
    slope = torch.where(y > 0, -af / torch.where(y > 0, root, 1.0), 0.0)
    h_prev = torch.cat([torch.zeros_like(hf[:, :1]), hf[:, :-1]], 1)
    dx = g * root
    da = g * (h_prev + xf * slope)
    return da.to(a.dtype), dx.to(x.dtype)
