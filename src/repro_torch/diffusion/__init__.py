"""Diffusion substrate, PyTorch port: MMDiT backbone, encoders, sampling,
LoRA adapters, servable model wrappers and the basic and LoRA workflow
builders."""

from repro_torch.diffusion.config import (
    FAMILIES,
    FLUX_DEV,
    FLUX_SCHNELL,
    REAL,
    SD3,
    SD35_LARGE,
    SDXL,
    DiffusionFamily,
    DiTConfig,
)
from repro_torch.diffusion.ops import (
    DenoiseSegment,
    DenoiseStep,
    DiffusionBackbone,
    LatentsGenerator,
    LoRAAdapter,
    TextEncoder,
    VAEDecode,
)
from repro_torch.diffusion.workflows import (
    ModelSet,
    make_basic_workflow,
    make_lora_workflow,
)
