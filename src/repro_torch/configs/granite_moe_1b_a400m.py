"""Assigned architecture config: granite_moe_1b_a400m."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=32, experts_per_token=8,
    swa_decode_variant=True,
    citation="IBM Granite 3.0 1b-a400m-base [hf:ibm-granite/granite-3.0-1b-a400m-base]",
)
