"""Workflow builders over the servable component models, PyTorch port.

The component :class:`~repro_torch.core.model.Model` subclasses live in
:mod:`repro_torch.diffusion.ops`; this module composes them into the
paper's Basic and +LoRA workflow templates.  The ControlNet template (and
Table 2's settings built from it) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.workflow import WorkflowTemplate, compose
from repro_torch.diffusion.config import FAMILIES, DiffusionFamily
from repro_torch.diffusion.ops import (
    DenoiseStep,
    DiffusionBackbone,
    LatentsGenerator,
    LoRAAdapter,
    TextEncoder,
    VAEDecode,
)
from repro_torch.diffusion.sampler import flow_schedule


class ModelSet:
    """Shared model instances for one family (sharing is by model_id):
    the basic workflow's members."""

    def __init__(self, family: DiffusionFamily) -> None:
        self.family = family
        self.latents = LatentsGenerator(family)
        self.text_enc = TextEncoder(family)
        self.backbone = DiffusionBackbone(family)
        self.vae_dec = VAEDecode(family)
        self.denoise = DenoiseStep(family)


def _denoising_loop(ms: ModelSet, lat, emb, steps: int, guidance: float) -> Any:
    sched = [float(x) for x in flow_schedule(steps)]
    for i in range(steps):
        t_cur, t_next = sched[i], sched[i + 1]
        v = ms.backbone(
            latents=lat, prompt_embeds=emb, t=t_cur,
            controlnet_residuals=None, guidance=guidance,
        )
        lat = ms.denoise(v, lat, t_cur, t_next)
    return lat


def make_basic_workflow(family_name: str, ms: Optional[ModelSet] = None) -> WorkflowTemplate:
    family = FAMILIES[family_name]
    ms = ms or ModelSet(family)

    @compose(f"{family.name}:basic")
    def wf_fn(wf, steps=family.denoise_steps, guidance=4.5):
        seed = wf.add_input("seed", int)
        prompt = wf.add_input("prompt", str)
        lat = ms.latents(seed)
        emb = ms.text_enc(prompt)
        lat = _denoising_loop(ms, lat, emb, steps, guidance)
        img = ms.vae_dec(lat)
        wf.add_output(img, name="image")

    return wf_fn


def make_lora_workflow(
    family_name: str, lora_name: str = "style", ms: Optional[ModelSet] = None
) -> WorkflowTemplate:
    """The Basic workflow with a LoRA adapter patched into the backbone.

    The family comes from ``ms`` when one is given (the JAX package takes
    ``FAMILIES[family_name]`` even then, so a full-width ``ModelSet`` would
    get a toy-width patched backbone and adapter there); without ``ms`` it
    is ``FAMILIES[family_name]``, as in the JAX package."""
    family = ms.family if ms is not None else FAMILIES[family_name]
    ms = ms or ModelSet(family)
    # a fresh backbone instance so the patch does not leak into other
    # workflows sharing the ModelSet (model_id and weights stay identical,
    # so the two share one set of loaded components)
    backbone = DiffusionBackbone(family, weights=ms.backbone.weights)
    backbone.add_patch(LoRAAdapter(family, lora_name))
    patched = ModelSet(family)
    patched.backbone = backbone
    patched.latents, patched.text_enc = ms.latents, ms.text_enc
    patched.vae_dec, patched.denoise = ms.vae_dec, ms.denoise

    @compose(f"{family.name}:lora:{lora_name}")
    def wf_fn(wf, steps=family.denoise_steps, guidance=4.5):
        seed = wf.add_input("seed", int)
        prompt = wf.add_input("prompt", str)
        lat = patched.latents(seed)
        emb = patched.text_enc(prompt)
        lat = _denoising_loop(patched, lat, emb, steps, guidance)
        img = patched.vae_dec(lat)
        wf.add_output(img, name="image")

    return wf_fn
