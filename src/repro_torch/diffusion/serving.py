"""Back-compat shim: ``repro_torch.diffusion.serving`` re-exports
:mod:`repro_torch.diffusion.ops` (the servable Model subclasses) and
:mod:`repro_torch.diffusion.workflows` (ModelSet + Table-2 workflow
builders), as the JAX package's ``serving`` module does.

The sharded plane's ``_mesh_fn_cache`` and ``_mesh_put`` are not here:
the sharded plane is not ported yet.
"""

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
    _split_rows,
)
from repro_torch.diffusion.workflows import (
    ModelSet,
    _denoising_loop,
    make_basic_workflow,
    make_controlnet_workflow,
    make_lora_workflow,
    table2_setting,
)

__all__ = [
    "ControlNet",
    "DenoiseSegment",
    "DenoiseStep",
    "DiffusionBackbone",
    "LatentsGenerator",
    "LoRAAdapter",
    "ModelSet",
    "ResidualCombine",
    "TextEncoder",
    "VAEDecode",
    "VAEEncode",
    "make_basic_workflow",
    "make_controlnet_workflow",
    "make_lora_workflow",
    "table2_setting",
]
