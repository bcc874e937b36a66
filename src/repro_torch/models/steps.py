"""Serving step builders per architecture: ``prefill_step`` and
``serve_step``, plus the synthetic batch of the smoke runs.

The JAX package's ``make_train_step``, ``make_loss_fn`` and
``cross_entropy`` belong to training, which the port has not taken yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.api import get_family
from repro_torch.models.base import ArchConfig, InputShape


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
