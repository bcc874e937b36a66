"""The LLM families of the assigned architectures (dense, MoE, SSM,
hybrid, enc-dec, VLM): their serving and training paths."""

from repro_torch.models.api import Family, frontend_inputs, get_family
from repro_torch.models.base import (
    DECODE_32K,
    INPUT_SHAPES,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ArchConfig,
    InputShape,
)
from repro_torch.models.steps import (
    cross_entropy,
    make_loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    synthetic_batch,
)
