"""Diffusion substrate, PyTorch port: MMDiT backbone, encoders, sampling,
LoRA adapters, servable model wrappers and the Table-2 workflow builders."""

from repro_torch.diffusion.cache import ApproxCache
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
    ControlNet,
    DenoiseSegment,
    DenoiseStep,
    DiffusionBackbone,
    LatentsGenerator,
    LoRAAdapter,
    ResidualCombine,
    TextEncoder,
    VAEDecode,
    VAEEncode,
)
from repro_torch.diffusion.workflows import (
    ModelSet,
    make_basic_workflow,
    make_controlnet_workflow,
    make_lora_workflow,
    table2_setting,
)
