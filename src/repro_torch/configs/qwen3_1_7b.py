"""Assigned architecture config: qwen3_1_7b."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="qwen3-1.7b",
    arch_type="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1000000.0,
    swa_decode_variant=True,
    citation="Qwen3 (qk_norm, GQA) [hf:Qwen/Qwen3-8B]",
)
