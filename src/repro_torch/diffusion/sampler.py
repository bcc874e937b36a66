"""Rectified-flow sampling + classifier-free guidance, PyTorch port.

* :func:`flow_schedule` — the timestep grid (t: 1 -> 0);
* :func:`denoise_step` — one Euler step of the probability-flow ODE, the
  ONE update routine both the per-step ``DenoiseStep`` node and the fused
  ``DenoiseSegment`` call, so fused == unfused bit for bit inside the port
  (the JAX package gets the same guarantee by jitting the step);
  :func:`denoise_step_` is its in-place form for a donated carry
  (``REPRO_DONATE``), with the same bits;
* :func:`cfg_combine` / :func:`fused_cfg_velocity` — classifier-free
  guidance [26], one-pass (cond and null rows stacked on the batch axis,
  :func:`fold_cfg` and :func:`combine_cfg_rows`); :func:`cfg_velocity`,
  the sequential two-pass form;
* :func:`latent_parallel_velocity` — latent parallelism: the two CFG
  passes on the two slots of a :class:`~repro_torch.core.mesh.Submesh`.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.diffusion.config import DiTConfig
from repro_torch.diffusion.mmdit import mmdit_apply


# ----------------------------------------------------- donated latent buffers
#
# ``REPRO_DONATE=1`` makes the fused segment update its latent carry in
# place (:func:`denoise_step_`) instead of allocating ``lat + dt * v``
# every step.  Donation invariant: only a tensor the segment owns is
# updated in place.  ``DenoiseSegment`` stacks its inputs with
# ``torch.cat``, which always copies, so the datastore's value, a caller's
# tensor or an ``ApproxCache`` entry is never written; the per-step
# ``DenoiseStep`` node reads an engine-held value and stays out of place.
# Read at load time (``DenoiseSegment.load`` records it in the
# components), like the quant flag.

_donate_enabled: bool = os.environ.get(
    "REPRO_DONATE", "0").lower() not in ("0", "false", "off", "")


def set_donate_buffers(enabled: bool) -> bool:
    """Toggle latent-buffer donation; returns the previous value.  Takes
    effect on the next model load."""
    global _donate_enabled
    prev = _donate_enabled
    _donate_enabled = bool(enabled)
    return prev


def donate_buffers_enabled() -> bool:
    return _donate_enabled


def flow_schedule(num_steps: int, shift: float = 1.0) -> torch.Tensor:
    """Timesteps t_0=1 ... t_N=0 (rectified flow, optional SD3 shift)."""
    t = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32)
    if shift != 1.0:
        t = shift * t / (1 + (shift - 1) * t)
    return t


def _step_size(latents: torch.Tensor, t_cur: torch.Tensor,
               t_next: torch.Tensor) -> torch.Tensor:
    dt = (t_next - t_cur).to(latents.dtype)
    return dt.reshape((latents.shape[0],) + (1,) * (latents.dim() - 1))


def denoise_step(latents: torch.Tensor, velocity: torch.Tensor,
                 t_cur: torch.Tensor, t_next: torch.Tensor) -> torch.Tensor:
    """Euler step of dx/dt = v: x_{t_next} = x + (t_next - t_cur) * v.

    ``t_cur``/``t_next`` are f32 ``[B]`` vectors (one time per latent
    row); the step size is taken in f32, then in the latents' dtype."""
    return latents + _step_size(latents, t_cur, t_next) * velocity


def denoise_step_(latents: torch.Tensor, velocity: torch.Tensor,
                  t_cur: torch.Tensor, t_next: torch.Tensor) -> torch.Tensor:
    """:func:`denoise_step` in place: ``latents`` (a carry the caller owns)
    becomes the result and is returned.  The same product ``dt * v`` is
    rounded, then added, so the bits equal the out-of-place step's."""
    return latents.add_(_step_size(latents, t_cur, t_next) * velocity)


def cfg_combine(v_uncond: torch.Tensor, v_cond: torch.Tensor,
                guidance: Any) -> torch.Tensor:
    return v_uncond + guidance * (v_cond - v_uncond)


def fold_cfg(latents: torch.Tensor, t: torch.Tensor, text_emb: torch.Tensor,
             control_residuals: Optional[torch.Tensor] = None) -> tuple:
    """CFG folded onto the batch axis: the B rows twice, the conditional
    embedding on the first B and zeros (the null embedding) on the last.
    The residuals are layer-major ``[L, B, Ti, d]``, so they double on
    axis 1.  Returns ``(latents, t, emb, residuals)`` of 2B rows."""
    res2 = None
    if control_residuals is not None:
        res2 = torch.cat([control_residuals, control_residuals], dim=1)
    return (torch.cat([latents, latents], dim=0), torch.cat([t, t], dim=0),
            torch.cat([text_emb, torch.zeros_like(text_emb)], dim=0), res2)


def combine_cfg_rows(v2: torch.Tensor, guidance: Any) -> torch.Tensor:
    """The guided velocity of a CFG-folded batch (conditional rows first).
    ``guidance`` may be a scalar or a per-item [B] vector (cross-request
    batches with mixed guidance)."""
    b = v2.shape[0] // 2
    v_c, v_u = v2[:b], v2[b:]
    g = torch.as_tensor(guidance, dtype=v2.dtype, device=v2.device)
    if g.dim():                      # per-item guidance: broadcast over space
        g = g.reshape((b,) + (1,) * (v2.dim() - 1))
    return cfg_combine(v_u, v_c, g)


def fused_cfg_velocity(
    apply_fn: Callable[..., torch.Tensor],
    params: Dict[str, Any],
    latents: torch.Tensor,
    t: torch.Tensor,
    text_emb: torch.Tensor,
    guidance: Any = 4.5,
    control_residuals: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-pass CFG: cond and null embeddings stacked on the batch axis.

    ``apply_fn(params, latents, t, emb, residuals)`` runs ONCE on a 2B
    batch instead of twice on B."""
    v2 = apply_fn(params, *fold_cfg(latents, t, text_emb, control_residuals))
    return combine_cfg_rows(v2, guidance)


def cfg_velocity(
    params: Dict[str, Any],
    cfg: DiTConfig,
    latents: torch.Tensor,
    t: torch.Tensor,
    text_emb: torch.Tensor,
    null_emb: torch.Tensor,
    guidance: float = 4.5,
    control_residuals: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequential CFG: two backbone passes on one device."""
    v_c = mmdit_apply(params, cfg, latents, t, text_emb, control_residuals)
    v_u = mmdit_apply(params, cfg, latents, t, null_emb, control_residuals)
    return cfg_combine(v_u, v_c, guidance)


def latent_parallel_velocity(
    mesh: Any,
    params: Any,
    cfg: DiTConfig,
    latents: torch.Tensor,
    t: torch.Tensor,
    text_emb: torch.Tensor,
    null_emb: torch.Tensor,
    guidance: float = 4.5,
) -> torch.Tensor:
    """CFG with the two passes split across a 2-slot submesh.

    Slot 0 computes the conditional velocity and slot 1 the unconditional
    one, each weighted by its share of the guided combination
    (``g * v_cond + (1 - g) * v_uncond``); the JAX package's ``psum`` over
    its ``cfg`` axis becomes the sum of the two weighted parts on the home
    slot: the scatter-gather synchronization of Fig. 2, once per step.
    ``params`` is one tree (replicated here) or one tree per slot."""
    if mesh.size != 2:
        raise ValueError(f"latent parallelism uses 2 slots, not {mesh.size}")
    replicas = (list(params) if isinstance(params, (list, tuple))
                else mesh.replicate(params))
    parts = [w * mmdit_apply(p, cfg, latents.to(d), t.to(d), emb.to(d))
             for p, d, emb, w in zip(replicas, mesh.devices,
                                     (text_emb, null_emb),
                                     (guidance, 1.0 - guidance))]
    return parts[0].to(mesh.home) + parts[1].to(mesh.home)
