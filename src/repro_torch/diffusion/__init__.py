"""Diffusion substrate, PyTorch port: MMDiT backbone, encoders, sampling,
servable model wrappers and the basic workflow builder."""

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
    TextEncoder,
    VAEDecode,
)
from repro_torch.diffusion.workflows import ModelSet, make_basic_workflow
