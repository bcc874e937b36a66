"""AdamW and Adafactor over the port's parameter trees (no torch.optim).

The JAX package's update rules, step for step: moments are kept in fp32
whatever the parameter dtype, and the update is computed in fp32 and cast
back.  AdamW clips by the global gradient norm, adds ``weight_decay * p``
to the update before the learning rate scales it, and only for leaves of
two or more dimensions, under its own warm-up-and-cosine schedule; that
is why ``torch.optim.AdamW`` (decoupled decay on every leaf) is not used.

The states are NamedTuples with the JAX package's fields, so a checkpoint
of either package names the same leaves.  Unlike the JAX package's pure
functions, the updates write the parameters and moments in place (under
``no_grad``) and return the same tensors: a functional update would hold
a second copy of the parameters and both moments, 20 GB at
recurrentgemma-2b's width over 5 layers.  The step counter is a new
tensor each step.  The learning rate, clip scale and bias corrections are
0-d float32 tensors on the parameters' device, so a step never waits on
the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.train.tree import leaves, map_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


def _device(params: Any) -> torch.device:
    ls = leaves(params)
    return ls[0].device if ls else torch.device("cpu")


def _f32_zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def adamw_init(params: Any) -> AdamWState:
    def zeros(p):
        return _f32_zeros(p.shape, p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=_device(params)),
                      mu=map_leaves(zeros, params), nu=map_leaves(zeros, params))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine down to a tenth of ``lr``; ``step`` is
    the int32 count of steps taken, the result a float32 scalar."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
        0.0, 1.0)
    cosine = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cosine)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in leaves(tree)))


class AdafactorState(NamedTuple):
    """Factored second-moment state (Shazeer & Stern 2018): for matrices,
    row/column statistics replace the full moment, O(n+m) memory instead
    of O(nm).  No first moment (beta1 = 0)."""

    step: torch.Tensor      # int32 scalar
    vr: Any                 # row stats: mean of g^2 over the last dim
    vc: Any                 # col stats: mean of g^2 over dim -2 (matrices)


def adafactor_init(params: Any) -> AdafactorState:
    def row(p):
        return _f32_zeros(p.shape[:-1] if p.dim() >= 2 else p.shape, p.device)

    def col(p):
        if p.dim() >= 2:
            return _f32_zeros(p.shape[:-2] + p.shape[-1:], p.device)
        return _f32_zeros((), p.device)

    return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                           device=_device(params)),
                          vr=map_leaves(row, params), vc=map_leaves(col, params))


def _write(p: torch.Tensor, delta: torch.Tensor, lr: torch.Tensor) -> None:
    """p <- (p - lr * delta) in fp32, cast back to p's dtype; ``delta`` is
    consumed."""
    delta.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(delta)
    else:
        p.copy_(p.float() - delta)


@torch.no_grad()
def adafactor_update(
    cfg: AdamWConfig, params: Any, grads: Any, state: AdafactorState
) -> Tuple[Any, AdafactorState, Dict[str, torch.Tensor]]:
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    beta2 = 1.0 - torch.pow(step.float(), -0.8)
    eps = 1e-30
    for p, g, r, c in zip(leaves(params), leaves(grads), leaves(state.vr),
                          leaves(state.vc)):
        g = g.float()
        g2 = g * g + eps
        if p.dim() >= 2:
            r.copy_(beta2 * r + (1 - beta2) * torch.mean(g2, dim=-1))
            c.copy_(beta2 * c + (1 - beta2) * torch.mean(g2, dim=-2))
            denom = torch.clamp(torch.mean(r, dim=-1, keepdim=True), min=eps)
            v = (r[..., None] * c[..., None, :]) / denom[..., None]
        else:
            r.copy_(beta2 * r + (1 - beta2) * g2)
            v = r
        del g2
        u = g / torch.sqrt(v + 1e-12)
        del v
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp(rms_u, min=1.0)
        if p.dim() >= 2:
            u = u + cfg.weight_decay * p.float()
        _write(p, u, lr)
    return params, AdafactorState(step, state.vr, state.vc), {"lr": lr}


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params: Any, grads: Any, state: AdamWState
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, state.step)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        # each line rounds as the JAX package's expression does
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        g2 = (1 - cfg.b2) * g
        g2.mul_(g)
        del g
        v.mul_(cfg.b2).add_(g2)
        del g2
        delta = m / bc1
        denom = v / bc2
        denom.sqrt_().add_(cfg.eps)
        delta.div_(denom)
        del denom
        if p.dim() >= 2:                    # decay matrices only
            delta.add_(cfg.weight_decay * p.float())
        _write(p, delta, lr)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
