"""Servable diffusion component models (the ``Model`` subclasses), PyTorch
port of the basic text-to-image workflow's components.

Every component's ``cost()`` carries the real-scale statistics (for the
profiles and the scheduler) and its ``load()/execute()`` run the family's
``toy`` configuration, which may be the full published width
(``dataclasses.replace(SD3, toy=REAL["sd3"])``).

Devices: ``load(device)`` builds the components on the backend's device
(``"cuda"`` when none is given), drawing weights there from a
``torch.Generator`` seeded from the model id, or moving the converted
``weights`` a caller handed in.  The trivial ops run inline on the
coordinator without components: ``LatentsGenerator`` draws on the CPU
from a generator seeded with the request's seed, so the CPU and the card
start from the same latents, and every executor-run op moves its inputs
onto its components' device before it computes.

Single-device ``execute``/``execute_batch`` only: ControlNet, LoRA (fold
or grouped), quantized forwards, donation and the sharded plane are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.model import Model, ModelCost
from repro_torch.core.types import Image, TensorType
from repro_torch.diffusion.config import DiffusionFamily, DiTConfig
from repro_torch.diffusion.encoders import (
    init_text_encoder,
    init_vae,
    stable_hash,
    text_encoder_apply,
    tokenize_batch,
    vae_decode,
)
from repro_torch.diffusion.mmdit import init_mmdit, mmdit_apply
from repro_torch.diffusion.sampler import denoise_step, fused_cfg_velocity
from repro_torch.weights import to_device

_TOY_VOCAB = 512


def _split_rows(val: torch.Tensor, sizes: List[int], dim: int = 0
                ) -> List[torch.Tensor]:
    """Split a stacked batch back into per-request chunks along ``dim``."""
    return list(torch.split(val, sizes, dim=dim))


def _device(device: Any) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _generator(device: torch.device, name: str) -> torch.Generator:
    """Weight-init generator on ``device``, seeded from a model id."""
    return torch.Generator(device=device).manual_seed(stable_hash(name) % 2**31)


def _f32_rows(values: Sequence[float], sizes: Sequence[int],
              device: torch.device) -> torch.Tensor:
    """Per-item scalars as one f32 [B_rows] vector, built host-side in ONE
    transfer."""
    return torch.from_numpy(np.repeat(
        np.asarray(values, np.float32), sizes)).to(device)


# --------------------------------------------------------------------------
# Component models
# --------------------------------------------------------------------------

class LatentsGenerator(Model):
    """Initial noise.  ``source(seed)`` may replace the draw (a test hands
    in the JAX package's latents); by default a CPU ``torch.Generator``
    seeded with ``seed`` draws them."""

    trivial = True

    def __init__(self, family: DiffusionFamily,
                 source: Optional[Callable[[int], torch.Tensor]] = None) -> None:
        self.family = family
        self.source = source
        super().__init__(model_id="latents_generator")

    def setup_io(self) -> None:
        self.add_input("seed", int)
        self.add_output("latents", TensorType())

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        seed = int(kw["seed"])
        if self.source is not None:
            return {"latents": self.source(seed)}
        cfg = self.family.toy
        gen = torch.Generator(device="cpu").manual_seed(seed)
        lat = torch.randn(
            (1, cfg.latent_size, cfg.latent_size, cfg.latent_channels),
            generator=gen, dtype=torch.float32)
        return {"latents": lat}

    def cost(self) -> ModelCost:
        return ModelCost(1e6, 0, 1e6, self.family.latent_bytes(), max_batch=64)


class TextEncoder(Model):
    def __init__(self, family: DiffusionFamily,
                 weights: Optional[Dict[str, Any]] = None) -> None:
        self.family = family
        self.weights = weights
        super().__init__(model_id=f"text_encoder:{family.name}")

    def setup_io(self) -> None:
        self.add_input("prompt", str)
        self.add_output("prompt_embeds", TensorType())

    def load(self, device: Any = None) -> Dict[str, Any]:
        dev = _device(device)
        cfg = self.family.toy
        if self.weights is not None:
            params = to_device(self.weights, dev)
        else:
            params = init_text_encoder(
                _generator(dev, self.model_id), _TOY_VOCAB, cfg.text_dim,
                n_layers=2, n_heads=4, max_len=cfg.text_tokens)
        return {"params": params, "device": dev}

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        return self.execute_batch(model_components, [kw])[0]

    def execute_batch(
        self, model_components: Dict[str, Any], batch_kwargs: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        cfg = self.family.toy
        ids = tokenize_batch([kw["prompt"] for kw in batch_kwargs],
                             _TOY_VOCAB, cfg.text_tokens,
                             model_components["device"])
        emb = text_encoder_apply(model_components["params"], ids, n_heads=4)
        return [{"prompt_embeds": emb[i:i + 1]} for i in range(len(batch_kwargs))]

    def cost(self) -> ModelCost:
        f = self.family
        return ModelCost(
            flops_per_item=f.text_encode_flops(),
            param_bytes=f.text_encoder_bytes(),
            act_io_bytes=f.text_encoder_bytes(),      # memory-bound at b=1
            output_bytes=f.text_tokens * 4096 * 2.0,
            max_batch=32,
        )


class DiffusionBackbone(Model):
    """One denoising step of the base diffusion model (CFG included).
    The ControlNet residuals are a deferred input (§7.3)."""

    scan_role = "backbone"

    def __init__(self, family: DiffusionFamily,
                 weights: Optional[Dict[str, Any]] = None) -> None:
        self.family = family
        self.weights = weights
        super().__init__(model_id=f"backbone:{family.name}")

    def setup_io(self) -> None:
        self.add_input("latents", TensorType())
        self.add_input("prompt_embeds", TensorType())
        self.add_input("t", float)
        self.add_input("controlnet_residuals", TensorType(), deferred=True)
        self.add_input("guidance", float)
        self.add_output("velocity", TensorType())

    def load(self, device: Any = None) -> Dict[str, Any]:
        dev = _device(device)
        cfg = self.family.toy
        if self.weights is not None:
            params = to_device(self.weights, dev)
        else:
            params = init_mmdit(_generator(dev, self.model_id), cfg)
        return {"params": params, "cfg": cfg, "device": dev}

    def velocity(
        self,
        model_components: Dict[str, Any],
        lat: torch.Tensor,
        t: torch.Tensor,
        emb: torch.Tensor,
        res: Optional[torch.Tensor],
        guidance: torch.Tensor,
    ) -> torch.Tensor:
        """The guided velocity of one stacked forward: the one routine the
        per-step node and the fused segment both call.  ``t`` and
        ``guidance`` are f32 ``[B]`` vectors on the components' device."""
        cfg: DiTConfig = model_components["cfg"]
        params = model_components["params"]

        def apply(p, l, tt, e, r):
            return mmdit_apply(p, cfg, l, tt, e, r)

        if self.family.uses_cfg:
            return fused_cfg_velocity(apply, params, lat, t, emb, guidance, res)
        return apply(params, lat, t, emb, res)

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        return self.execute_batch(model_components, [kw])[0]

    def execute_batch(
        self, model_components: Dict[str, Any], batch_kwargs: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Stacked cross-request forward.  Batch axis is axis 0 for
        latents/embeddings but axis 1 for the layer-major ControlNet
        residual stacks; timesteps and guidance become per-item vectors."""
        stacked = self._stack_batch(model_components["device"], batch_kwargs)
        if stacked is None:
            return self._execute_sequential(model_components, batch_kwargs)
        lat, emb, t, res, guidance, sizes = stacked
        v = self.velocity(model_components, lat, t, emb, res, guidance)
        return [{"velocity": chunk} for chunk in _split_rows(v, sizes)]

    @staticmethod
    def _stack_batch(
        dev: torch.device, batch_kwargs: List[Dict[str, Any]]
    ) -> Optional[Tuple]:
        """Stack a cross-request batch onto ``dev``: (lat, emb, t, res,
        guidance, sizes), or None when stacking would be unsound (shapes
        disagree, or only some requests carry ControlNet residuals)."""
        lats = [kw["latents"] for kw in batch_kwargs]
        embs = [kw["prompt_embeds"] for kw in batch_kwargs]
        ress = [kw.get("controlnet_residuals") for kw in batch_kwargs]
        if (any(l.shape[1:] != lats[0].shape[1:] for l in lats[1:])
                or any(e.shape[1:] != embs[0].shape[1:] for e in embs[1:])):
            return None
        if any(r is None for r in ress) and any(r is not None for r in ress):
            return None
        sizes = [int(l.shape[0]) for l in lats]
        lat = torch.cat([l.to(dev) for l in lats], dim=0)
        emb = torch.cat([e.to(dev) for e in embs], dim=0)
        res = (None if ress[0] is None
               else torch.cat([r.to(dev) for r in ress], dim=1))
        t = _f32_rows([float(kw["t"]) for kw in batch_kwargs], sizes, dev)
        guidance = _f32_rows([float(kw.get("guidance", 4.5))
                              for kw in batch_kwargs], sizes, dev)
        return lat, emb, t, res, guidance, sizes

    def cost(self) -> ModelCost:
        f = self.family
        tokens = f.image_tokens + f.text_tokens
        return ModelCost(
            flops_per_item=f.backbone_step_flops(),
            param_bytes=f.backbone_bytes(),
            act_io_bytes=12.0 * f.n_layers_real * tokens * f.d_model_real * 2.0,
            output_bytes=f.image_tokens * 16 * 2.0,
            max_parallelism=4,
            max_batch=8,
            calls_per_request=f.denoise_steps,
        )

    def build_segment(self, controlnets: List[Model],
                      n_steps: int) -> "DenoiseSegment":
        """Factory the :class:`~repro_torch.core.passes.SegmentFusionPass`
        calls to materialize a fused multi-step op for a recognized chain."""
        return DenoiseSegment(self, controlnets, n_steps)


class VAEDecode(Model):
    def __init__(self, family: DiffusionFamily,
                 weights: Optional[Dict[str, Any]] = None) -> None:
        self.family = family
        self.weights = weights
        super().__init__(model_id=f"vae:{family.name}")

    def setup_io(self) -> None:
        self.add_input("latents", TensorType())
        self.add_output("image", Image)

    def load(self, device: Any = None) -> Dict[str, Any]:
        dev = _device(device)
        if self.weights is not None:
            params = to_device(self.weights, dev)
        else:
            params = init_vae(_generator(dev, f"vae:{self.family.name}"),
                              latent_channels=self.family.toy.latent_channels)
        return {"params": params, "device": dev}

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        return self.execute_batch(model_components, [kw])[0]

    def execute_batch(
        self, model_components: Dict[str, Any], batch_kwargs: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        lats = [kw["latents"] for kw in batch_kwargs]
        if any(l.shape[1:] != lats[0].shape[1:] for l in lats[1:]):
            return self._execute_sequential(model_components, batch_kwargs)
        sizes = [int(l.shape[0]) for l in lats]
        dev = model_components["device"]
        img = vae_decode(model_components["params"],
                         torch.cat([l.to(dev) for l in lats], dim=0))
        return [{"image": chunk} for chunk in _split_rows(img, sizes)]

    def cost(self) -> ModelCost:
        f = self.family
        return ModelCost(
            flops_per_item=f.vae_decode_flops(),
            param_bytes=f.vae_bytes(),
            act_io_bytes=f.image_tokens * 64 * 48.0,
            output_bytes=f.image_tokens * 64 * 3 * 1.0,   # uint8 pixels
            max_parallelism=2,
            max_batch=16,
        )


class DenoiseStep(Model):
    """Euler scheduler step — trivial arithmetic, runs inline on the
    velocity's device."""

    trivial = True
    scan_role = "denoise"

    def __init__(self, family: DiffusionFamily) -> None:
        self.family = family
        super().__init__(model_id="denoise_step")

    def setup_io(self) -> None:
        self.add_input("velocity", TensorType())
        self.add_input("latents", TensorType())
        self.add_input("t_cur", float)
        self.add_input("t_next", float)
        self.add_output("latents", TensorType())

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        v = kw["velocity"]
        lat = kw["latents"].to(v.device)
        rows = [int(lat.shape[0])]
        lat = denoise_step(lat, v,
                           _f32_rows([float(kw["t_cur"])], rows, v.device),
                           _f32_rows([float(kw["t_next"])], rows, v.device))
        return {"latents": lat}

    def cost(self) -> ModelCost:
        return ModelCost(1e6, 0, 1e6, self.family.latent_bytes(), max_batch=64)


class DenoiseSegment(Model):
    """A fused run of S consecutive denoising steps — ONE dispatch.

    Built by :class:`~repro_torch.core.passes.SegmentFusionPass` from a
    recognized ``DiffusionBackbone → DenoiseStep`` chain.  Each step calls
    the backbone's own :meth:`DiffusionBackbone.velocity` and the shared
    :func:`~repro_torch.diffusion.sampler.denoise_step`, so a segment's
    output equals the unfused chain's bit for bit.

    The step schedule travels in the NODE inputs (``t_mid``/``t_cur``/
    ``t_next`` tuples + ``guidance``), not in the op: two workflows with
    different step counts share one ``model_id``, and cross-request
    batches may mix schedules.  The runtime executes segments in
    load-adaptive chunks via the reserved ``_seg_start`` / ``_seg_steps``
    kwargs.  Chains with ControlNet branches are not ported yet.
    """

    is_segment = True

    def __init__(self, backbone: DiffusionBackbone,
                 controlnets: Sequence[Model], n_steps: int) -> None:
        if controlnets:
            raise NotImplementedError(
                "DenoiseSegment: ControlNet chains are not ported yet")
        self.backbone = backbone
        self.family = backbone.family
        self.n_steps = int(n_steps)
        super().__init__(model_id="segment:" + backbone.model_id)

    def setup_io(self) -> None:
        self.add_input("latents", TensorType())
        self.add_input("prompt_embeds", TensorType())
        # untyped literal ports: the per-step schedule, captured by the
        # fusion pass from the unfused chain's node literals
        self.add_input("t_mid", None)
        self.add_input("t_cur", None)
        self.add_input("t_next", None)
        self.add_input("guidance", None)
        self.add_output("latents", TensorType())

    @property
    def patches(self) -> List[Model]:
        # the segment IS the backbone for patching purposes
        return self.backbone.patches

    def load(self, device: Any = None) -> Dict[str, Any]:
        return {"backbone": self.backbone.load(device)}

    @staticmethod
    def _chunk_of(kw: Dict[str, Any]) -> Tuple[int, int]:
        """(start, steps) of the chunk this call covers."""
        total = len(kw["t_mid"])
        start = int(kw.get("_seg_start", 0) or 0)
        steps = kw.get("_seg_steps")
        steps = total - start if steps is None else int(steps)
        return start, max(0, min(steps, total - start))

    def _run(self, comps: Dict[str, Any], batch_kwargs: List[Dict[str, Any]],
             sizes: List[int], steps: int, lat: torch.Tensor,
             emb: torch.Tensor) -> torch.Tensor:
        """``steps`` Euler steps of the stacked batch, each one guided
        backbone forward plus the shared update."""
        dev = comps["backbone"]["device"]
        cols = {"t_mid": [], "t_cur": [], "t_next": []}
        gs = []
        for kw in batch_kwargs:
            start, _ = self._chunk_of(kw)
            for name in cols:
                cols[name].append(kw[name][start:start + steps])
            g = kw.get("guidance")
            gs.append(4.5 if g is None else float(g))
        guidance = _f32_rows(gs, sizes, dev)
        for s in range(steps):
            t, tc, tn = (_f32_rows([c[s] for c in cols[name]], sizes, dev)
                         for name in ("t_mid", "t_cur", "t_next"))
            v = self.backbone.velocity(comps["backbone"], lat, t, emb, None,
                                       guidance)
            lat = denoise_step(lat, v, tc, tn)
        return lat

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        return self.execute_batch(model_components, [kw])[0]

    def execute_batch(
        self, model_components: Dict[str, Any], batch_kwargs: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        lats = [kw["latents"] for kw in batch_kwargs]
        embs = [kw["prompt_embeds"] for kw in batch_kwargs]
        chunks = [self._chunk_of(kw) for kw in batch_kwargs]
        steps = chunks[0][1]
        if (any(l.shape[1:] != lats[0].shape[1:] for l in lats[1:])
                or any(e.shape[1:] != embs[0].shape[1:] for e in embs[1:])
                or any(c[1] != steps for c in chunks[1:])):
            return self._execute_sequential(model_components, batch_kwargs)
        if steps <= 0:
            return [{"latents": l} for l in lats]
        dev = model_components["backbone"]["device"]
        sizes = [int(l.shape[0]) for l in lats]
        lat = torch.cat([l.to(dev) for l in lats], dim=0)
        emb = torch.cat([e.to(dev) for e in embs], dim=0)
        out = self._run(model_components, batch_kwargs, sizes, steps, lat, emb)
        return [{"latents": chunk} for chunk in _split_rows(out, sizes)]

    def cost(self) -> ModelCost:
        """PER-STEP terms with ``steps_per_call`` carrying the segment
        length; only the final latent leaves the device per chunk."""
        b = self.backbone.cost()
        return ModelCost(
            flops_per_item=b.flops_per_item,
            param_bytes=b.param_bytes,
            act_io_bytes=b.act_io_bytes,
            output_bytes=self.family.latent_bytes(),
            max_parallelism=b.max_parallelism,
            max_batch=b.max_batch,
            calls_per_request=1,
            steps_per_call=self.n_steps,
        )
