"""Workflow builders (Table 2's S1-S6) over the servable component
models, PyTorch port.

The component :class:`~repro_torch.core.model.Model` subclasses live in
:mod:`repro_torch.diffusion.ops`; this module composes them into the
paper's Basic / +ControlNet / +LoRA workflow templates.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.core.model import Model
from repro_torch.core.types import Image
from repro_torch.core.workflow import WorkflowTemplate, compose
from repro_torch.diffusion.config import FAMILIES, DiffusionFamily
from repro_torch.diffusion.ops import (
    ControlNet,
    DenoiseStep,
    DiffusionBackbone,
    LatentsGenerator,
    LoRAAdapter,
    ResidualCombine,
    TextEncoder,
    VAEDecode,
    VAEEncode,
)
from repro_torch.diffusion.sampler import flow_schedule


class ModelSet:
    """Shared model instances for one family (sharing is by model_id).

    ``vae_enc`` and ``vae_dec`` share the ``vae:<family>`` id and so one set
    of loaded components: a caller that hands one of them ``weights`` hands
    the other the same tree."""

    def __init__(self, family: DiffusionFamily) -> None:
        self.family = family
        self.latents = LatentsGenerator(family)
        self.text_enc = TextEncoder(family)
        self.backbone = DiffusionBackbone(family)
        self.cn1 = ControlNet(family, 1)
        self.cn2 = ControlNet(family, 2)
        self.vae_dec = VAEDecode(family)
        self.vae_enc = VAEEncode(family)
        self.denoise = DenoiseStep(family)
        self.combine = ResidualCombine(family)


def _denoising_loop(ms: ModelSet, lat, emb, steps: int, guidance: float,
                    controlnets: List[Model], cond_lat) -> Any:
    sched = [float(x) for x in flow_schedule(steps)]
    for i in range(steps):
        t_cur, t_next = sched[i], sched[i + 1]
        res = None
        for cn in controlnets:
            r = cn(lat, cond_lat, emb, t_cur)
            res = r if res is None else ms.combine(res, r)
        v = ms.backbone(
            latents=lat, prompt_embeds=emb, t=t_cur,
            controlnet_residuals=res, guidance=guidance,
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
        lat = _denoising_loop(ms, lat, emb, steps, guidance, [], None)
        img = ms.vae_dec(lat)
        wf.add_output(img, name="image")

    return wf_fn


def make_controlnet_workflow(
    family_name: str, n_controlnets: int = 1, ms: Optional[ModelSet] = None
) -> WorkflowTemplate:
    """The Basic workflow with ``n_controlnets`` (1 or 2) ControlNets
    conditioned on a ``ref_image`` input.  As :func:`make_lora_workflow`,
    the family comes from ``ms`` when one is given."""
    family = ms.family if ms is not None else FAMILIES[family_name]
    ms = ms or ModelSet(family)
    cns = [ms.cn1, ms.cn2][:n_controlnets]

    @compose(f"{family.name}:cn{n_controlnets}")
    def wf_fn(wf, steps=family.denoise_steps, guidance=4.5):
        seed = wf.add_input("seed", int)
        prompt = wf.add_input("prompt", str)
        ref_image = wf.add_input("ref_image", Image)
        lat = ms.latents(seed)
        emb = ms.text_enc(prompt)
        cond = ms.vae_enc(ref_image)
        lat = _denoising_loop(ms, lat, emb, steps, guidance, cns, cond)
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
        lat = _denoising_loop(patched, lat, emb, steps, guidance, [], None)
        img = patched.vae_dec(lat)
        wf.add_output(img, name="image")

    return wf_fn


# the families each of Table 2's settings serves
TABLE2_FAMILIES = {"s1": ("sd3",), "s2": ("sd3.5-large",),
                   "s3": ("flux-schnell",), "s4": ("flux-dev",),
                   "s5": ("sd3", "sd3.5-large"),
                   "s6": ("flux-schnell", "flux-dev")}


def table2_setting(setting: str,
                   model_sets: Optional[Dict[str, ModelSet]] = None
                   ) -> Dict[str, WorkflowTemplate]:
    """S1-S6 from Table 2: per-family (Basic, +C.N.1, +C.N.2) workflows,
    the three of a family sharing one :class:`ModelSet`.  ``model_sets``
    maps a family name to the ``ModelSet`` to use for it (a full-width
    family, or one carrying given weights); the others are built from
    ``FAMILIES`` as in the JAX package."""
    out: Dict[str, WorkflowTemplate] = {}
    for f in TABLE2_FAMILIES[setting.lower()]:
        ms = (model_sets or {}).get(f) or ModelSet(FAMILIES[f])
        for wf in (make_basic_workflow(f, ms),
                   make_controlnet_workflow(f, 1, ms),
                   make_controlnet_workflow(f, 2, ms)):
            out[wf.name] = wf
    return out
