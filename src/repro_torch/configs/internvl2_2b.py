"""Assigned architecture config: internvl2_2b."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="internvl2-2b",
    arch_type="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553,
    frontend_tokens=256, frontend_dim=1024,   # stub InternViT patch embeds
    swa_decode_variant=True,
    citation="InternVL2 (InternViT + InternLM2) [arXiv:2404.16821]",
)
