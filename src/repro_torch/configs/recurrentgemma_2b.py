"""Assigned architecture config: recurrentgemma_2b."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000,
    citation="RecurrentGemma (RG-LRU + local attn, 1:2) [arXiv:2402.19427]",
)
