"""Diffusion model family configs (§7.1, Table 2), PyTorch port.

Each family carries two scales:

* ``real-scale`` statistics — parameter counts / token geometry of the
  published checkpoints, used by the analytic latency profiles, the
  monolithic baselines, and the roofline analysis;
* a ``toy`` executable configuration — the same architecture at CPU-
  friendly size, used by the executable plane and the correctness tests.

:data:`REAL` holds the published backbone geometries.  A family served at
full width is ``dataclasses.replace(SD3, toy=REAL["sd3"])``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Architecture of an MMDiT backbone (also used for ControlNet branches)."""

    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    text_dim: int
    latent_size: int          # latent spatial resolution (square)
    latent_channels: int
    patch: int
    text_tokens: int
    dtype: torch.dtype = torch.float32

    @property
    def image_tokens(self) -> int:
        return (self.latent_size // self.patch) ** 2

    @property
    def tokens(self) -> int:
        return self.image_tokens + self.text_tokens

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class DiffusionFamily:
    """One base-model family from Table 2 (SD3, SD3.5-Large, Flux-*)."""

    name: str
    backbone_params: float        # real-scale parameter count
    text_encoder_params: float    # aggregate (CLIP-L/G + T5-XXL where used)
    vae_params: float
    controlnet_params: float
    denoise_steps: int
    uses_cfg: bool                # classifier-free guidance (2 passes/step)
    image_tokens: int             # 1024px -> 4096 tokens (patch-2 on /8 VAE)
    text_tokens: int
    d_model_real: int
    n_layers_real: int
    toy: DiTConfig = None         # executable config

    @property
    def cfg_factor(self) -> float:
        return 2.0 if self.uses_cfg else 1.0

    def backbone_step_flops(self) -> float:
        """FLOPs of ONE denoising step per request (incl. CFG passes)."""
        tokens = self.image_tokens + self.text_tokens
        return 2.0 * self.backbone_params * tokens * self.cfg_factor

    def controlnet_step_flops(self) -> float:
        tokens = self.image_tokens + self.text_tokens
        return 2.0 * self.controlnet_params * tokens * self.cfg_factor

    def text_encode_flops(self) -> float:
        return 2.0 * self.text_encoder_params * self.text_tokens

    def vae_decode_flops(self) -> float:
        # conv decoder over the full pixel grid; ~2 orders above param count
        return 2.5e12 * (self.image_tokens / 4096.0)

    # ------------------------------------------------------------- bytes
    def backbone_bytes(self) -> float:
        return self.backbone_params * 2.0          # fp16/bf16 weights

    def text_encoder_bytes(self) -> float:
        return self.text_encoder_params * 2.0

    def vae_bytes(self) -> float:
        return self.vae_params * 2.0

    def controlnet_bytes(self) -> float:
        return self.controlnet_params * 2.0

    def workflow_footprint(self) -> float:
        return self.backbone_bytes() + self.text_encoder_bytes() + self.vae_bytes()

    def latent_bytes(self) -> float:
        # latent tensor (e.g. 128x128x16 fp16)
        return self.image_tokens * 4 * self.d_model_real / self.n_layers_real  # ~0.5-2MB

    def controlnet_residual_bytes(self) -> float:
        """Residual feature maps transferred per denoising step."""
        inj_layers = max(1, self.n_layers_real // 2)
        tokens = self.image_tokens + self.text_tokens
        return inj_layers * tokens * self.d_model_real * 2.0


_TOY = DiTConfig(
    d_model=64, n_layers=2, n_heads=4, d_ff=256, text_dim=64,
    latent_size=16, latent_channels=4, patch=2, text_tokens=8,
)

SD3 = DiffusionFamily(
    name="sd3",
    backbone_params=2.0e9,
    text_encoder_params=5.5e9,      # CLIP-L + CLIP-G + T5-XXL
    vae_params=8.4e7,
    controlnet_params=1.0e9,
    denoise_steps=28,
    uses_cfg=True,
    image_tokens=4096,
    text_tokens=333,
    d_model_real=1536,
    n_layers_real=24,
    toy=_TOY,
)

SD35_LARGE = DiffusionFamily(
    name="sd3.5-large",
    backbone_params=8.1e9,
    text_encoder_params=5.5e9,
    vae_params=8.4e7,
    controlnet_params=2.5e9,
    denoise_steps=40,
    uses_cfg=True,
    image_tokens=4096,
    text_tokens=333,
    d_model_real=2432,
    n_layers_real=38,
    toy=_TOY,
)

FLUX_DEV = DiffusionFamily(
    name="flux-dev",
    backbone_params=12.0e9,
    text_encoder_params=4.9e9,      # CLIP-L + T5-XXL
    vae_params=8.4e7,
    controlnet_params=0.72e9,       # ~6% of base (paper §7.3)
    denoise_steps=28,
    uses_cfg=False,                 # guidance-distilled
    image_tokens=4096,
    text_tokens=512,
    d_model_real=3072,
    n_layers_real=57,
    toy=_TOY,
)

FLUX_SCHNELL = DiffusionFamily(
    name="flux-schnell",
    backbone_params=12.0e9,
    text_encoder_params=4.9e9,
    vae_params=8.4e7,
    controlnet_params=0.72e9,
    denoise_steps=4,                # timestep-distilled
    uses_cfg=False,
    image_tokens=4096,
    text_tokens=512,
    d_model_real=3072,
    n_layers_real=57,
    toy=_TOY,
)

FAMILIES = {f.name: f for f in (SD3, SD35_LARGE, FLUX_DEV, FLUX_SCHNELL)}

# SDXL appears in the paper's §7.4 case studies (approximate caching, async
# LoRA); UNet-based, but for serving purposes only the costs matter.
SDXL = DiffusionFamily(
    name="sdxl",
    backbone_params=2.6e9,
    text_encoder_params=0.8e9,
    vae_params=8.4e7,
    controlnet_params=1.25e9,
    denoise_steps=30,
    uses_cfg=True,
    image_tokens=4096,
    text_tokens=77,
    d_model_real=1280,
    n_layers_real=70,
    toy=_TOY,
)
FAMILIES["sdxl"] = SDXL

# Real-scale backbone geometries (approximate published configs; the
# two-stream MMDiT block slightly over-parameterizes Flux's mixed
# joint/single-stream stack).  SD3: 2.05e9 backbone parameters, 4096 image
# tokens (128x128x16 latent, patch 2) and 333 text tokens.
REAL = {
    "sd3": DiTConfig(d_model=1536, n_layers=24, n_heads=24, d_ff=6144,
                     text_dim=4096, latent_size=128, latent_channels=16,
                     patch=2, text_tokens=333, dtype=torch.bfloat16),
    "sd3.5-large": DiTConfig(d_model=2432, n_layers=38, n_heads=38,
                             d_ff=9728, text_dim=4096, latent_size=128,
                             latent_channels=16, patch=2, text_tokens=333,
                             dtype=torch.bfloat16),
    "flux-dev": DiTConfig(d_model=3072, n_layers=57, n_heads=24, d_ff=12288,
                          text_dim=4096, latent_size=128, latent_channels=16,
                          patch=2, text_tokens=512, dtype=torch.bfloat16),
}
