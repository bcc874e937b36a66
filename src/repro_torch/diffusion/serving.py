"""Back-compat shim: ``repro_torch.diffusion.serving`` re-exports
:mod:`repro_torch.diffusion.ops` (the servable Model subclasses) and
:mod:`repro_torch.diffusion.workflows` (ModelSet + Table-2 workflow
builders), as the JAX package's ``serving`` module does.

The JAX package's shim also exports the sharded plane's two helpers.
``_mesh_put`` places an array on a submesh; its counterpart here is
``_shard_rows``, which splits a batch over a
:class:`~repro_torch.core.mesh.Submesh`'s slots with the submesh's
collectives.  ``_mesh_fn_cache`` caches compiled ``shard_map`` programs;
the port compiles nothing and has no counterpart.
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
    _shard_rows,
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
