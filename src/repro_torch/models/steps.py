"""Step builders: ``train_step``, ``prefill_step`` and ``serve_step`` per
architecture, plus the synthetic batch of the smoke runs.

``make_train_step`` is the training path: the loss over the padded
vocabulary (whose padded logits hold -1e9), gradients by
``torch.autograd.grad`` over the parameter tree's leaves, then AdamW or
Adafactor in place (:mod:`repro_torch.train.optimizer`).  Its kernels
carry gradients through their ``torch.autograd.Function``s: flash
attention in whisper's encoder, the RG-LRU scan in the hybrid.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.api import get_family
from repro_torch.models.base import ArchConfig, InputShape
from repro_torch.train.optimizer import (
    AdamWConfig,
    adafactor_update,
    adamw_update,
)
from repro_torch.train.tree import leaves, unflatten


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(ll)


def make_loss_fn(cfg: ArchConfig) -> Callable:
    fam = get_family(cfg)

    def loss_fn(params, batch):
        kwargs = {k: batch[k] for k in ("frames", "patches") if k in batch}
        logits = fam.forward(params, cfg, batch["tokens"], **kwargs)
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def _value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)``: ``jax.value_and_grad``'s
    counterpart.  The leaves enter the loss as detached views that require
    grad (no copy), and an unused leaf gets a zero gradient, as in JAX."""

    def value_and_grad(params, batch) -> Tuple[torch.Tensor, Any]:
        xs = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, xs), batch)
            grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), unflatten(params, list(grads))

    return value_and_grad


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: Optional[AdamWConfig] = None,
    accum_steps: int = 1,
    optimizer: str = "adamw",
    accum_dtype: Any = None,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``; the parameters and moments are updated
    in place.  ``accum_steps > 1`` loops over microbatches (the rows of the
    batch in ``accum_steps`` equal runs), accumulating the gradients in
    ``accum_dtype`` as the JAX package's scan does (memory-bound archs).
    ``optimizer='adafactor'`` uses the factored second moment (the 100B+
    regime); its gradient accumulator defaults to the param dtype."""
    opt_cfg = opt_cfg or AdamWConfig()
    grad_fn = _value_and_grad(make_loss_fn(cfg))
    update = adamw_update if optimizer == "adamw" else adafactor_update
    if accum_dtype is None and optimizer == "adamw":
        accum_dtype = torch.float32          # None: the param dtype

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = grad_fn(params, batch)
        else:
            acc = [torch.zeros_like(p, dtype=accum_dtype or p.dtype)
                   for p in leaves(params)]
            loss = 0.0
            for i in range(accum_steps):
                mb = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                l, g = grad_fn(params, mb)
                for a, gg in zip(acc, leaves(g)):
                    a.add_(gg.to(a.dtype))
                loss = loss + l
                del g
            grads = unflatten(params, [a / accum_steps for a in acc])
            loss = loss / accum_steps
        params, opt_state, metrics = update(opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """``prefill(params, batch) -> last_logits [B, padded_vocab]``."""
    fam = get_family(cfg)

    def prefill(params, batch):
        kwargs = {k: batch[k] for k in ("frames", "patches") if k in batch}
        logits = fam.forward(params, cfg, batch["tokens"], remat=False,
                             **kwargs)
        return logits[:, -1]

    return prefill


def make_serve_step(cfg: ArchConfig, ring: bool = False) -> Callable:
    """``serve_step(params, cache, token) -> (logits, cache)``: ONE new
    token against a ``seq_len``-deep cache or state (written in place)."""
    fam = get_family(cfg)

    def serve_step(params, cache, token):
        if cfg.arch_type in ("ssm", "hybrid"):
            return fam.decode_step(params, cfg, cache, token)
        return fam.decode_step(params, cfg, cache, token, ring=ring)

    return serve_step


def synthetic_batch(cfg: ArchConfig, shape: InputShape,
                    gen: Optional[torch.Generator] = None,
                    batch_override: Optional[int] = None,
                    seq_override: Optional[int] = None,
                    device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """Materialised synthetic batch drawn on ``device`` from ``gen`` (a
    generator seeded 0 there by default)."""
    gen = gen if gen is not None else torch.Generator(device).manual_seed(0)
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len

    def tokens():
        return torch.randint(0, cfg.vocab, (b, s), generator=gen,
                             device=device, dtype=torch.int64)

    batch = {"tokens": tokens(), "labels": tokens()}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=device)
    if cfg.frontend_tokens:
        batch["patches"] = torch.randn((b, cfg.frontend_tokens,
                                        cfg.frontend_dim),
                                       generator=gen, device=device)
    return batch
