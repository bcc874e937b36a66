"""Assigned architecture config: xlstm_1_3b."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(

    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    ssm_chunk=256,
    citation="xLSTM (sLSTM + mLSTM blocks) [arXiv:2405.04517]",
)
