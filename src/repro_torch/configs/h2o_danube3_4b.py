"""Assigned architecture config: h2o_danube3_4b."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="h2o-danube-3-4b",
    arch_type="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    sliding_window=4096,        # native SWA (llama+mistral mix)
    citation="H2O-Danube-3 [arXiv:2401.16818]",
)
