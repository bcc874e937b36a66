"""Unified model API over the six architecture families.

``get_family(cfg)`` returns a :class:`Family` facade with
``init / forward / init_decode_cache / decode_step`` whether the stack
underneath is a transformer, an xLSTM or a Griffin hybrid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models import hybrid, ssm, transformer
from repro_torch.models.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class Family:
    init: Callable[..., Any]
    forward: Callable[..., Any]
    init_decode_cache: Callable[..., Any]
    decode_step: Callable[..., Any]


def get_family(cfg: ArchConfig) -> Family:
    if cfg.arch_type == "ssm":
        return Family(ssm.init_params, ssm.forward,
                      ssm.init_decode_cache, ssm.decode_step)
    if cfg.arch_type == "hybrid":
        return Family(hybrid.init_params, hybrid.forward,
                      hybrid.init_decode_cache, hybrid.decode_step)
    # dense / moe / vlm / audio all route through the unified transformer
    return Family(transformer.init_params, transformer.forward,
                  transformer.init_decode_cache, transformer.decode_step)


def frontend_inputs(cfg: ArchConfig, batch: int,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Shapes of the stub modality frontends (the one allowed stub): VLM
    patch embeddings, audio frame embeddings."""
    out: Dict[str, Any] = {}
    if cfg.is_encoder_decoder:
        out["frames"] = (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.frontend_tokens:
        out["patches"] = (batch, cfg.frontend_tokens, cfg.frontend_dim)
    return out
