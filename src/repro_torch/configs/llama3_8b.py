"""Assigned architecture config: llama3_8b."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="llama3-8b",
    arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    rope_theta=500000.0,
    swa_decode_variant=True,   # long_500k carve-out (window 8192 ring cache)
    citation="Llama-3 herd of models [arXiv:2407.21783]",
)
