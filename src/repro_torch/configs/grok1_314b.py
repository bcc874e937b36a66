"""Assigned architecture config: grok1_314b."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="grok-1-314b",
    arch_type="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    n_experts=8, experts_per_token=2,
    swa_decode_variant=True,
    citation="Grok-1 (8 experts top-2) [hf:xai-org/grok-1]",
)
