"""Assigned architecture config: yi_34b."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="yi-34b",
    arch_type="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    rope_theta=5000000.0,
    swa_decode_variant=True,
    citation="Yi-34B (llama-arch GQA) [arXiv:2403.04652]",
)
