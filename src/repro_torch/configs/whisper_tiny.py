"""Assigned architecture config: whisper_tiny."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="whisper-tiny",
    arch_type="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    is_encoder_decoder=True, encoder_layers=4, encoder_seq=1500,
    citation="Whisper (enc-dec, stub conv frontend) [arXiv:2212.04356]",
)
