"""Servable diffusion component models (the ``Model`` subclasses), PyTorch
port of the basic, ControlNet and LoRA text-to-image workflows' components.

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
start from the same latents, ``DenoiseStep`` and ``ResidualCombine``
compute on their inputs' device, and every executor-run op moves its
inputs onto its components' device before it computes.

LoRA adapters apply two ways: folded into the backbone's weights once per
``(model_id, patch_ids)`` placement (``fold_patches``, when every request
of a batch carries the same adapter), or per row against the shared base
weights through the grouped ``lora_matmul`` kernel
(``execute_batch_multilora``, when a batch mixes tenants).

Under ``REPRO_QUANT=int8|fp8`` every load quantizes the projection weights
(the model's own draw and a caller's ``weights`` alike; quantizing a
quantized weight is the identity), and every fold requantizes, so the
components and the fold cache hold the small form.

The sharded plane: the backbone, the ControlNet branch, both VAE ops and
the fused segment take ``execute_batch_sharded``, which
:class:`~repro_torch.core.executor.ShardedBackend` calls with one
components tree per slot of a :class:`~repro_torch.core.mesh.Submesh`.
Rows split across the slots where they divide k (with CFG folded onto
the batch axis, k = 2 puts the two branches on two slots), and the
backbone and the segment shard the image tokens instead where they do not
(``mmdit_apply_seq_sharded``).  The JAX package caches one compiled
``shard_map`` program per placement (``_mesh_fn_cache``); the port
compiles nothing, so it has no such cache.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.model import Model, ModelCost
from repro_torch.core.types import Image, TensorType
from repro_torch.diffusion.config import DiffusionFamily, DiTConfig
from repro_torch.diffusion.encoders import (
    init_text_encoder,
    init_vae,
    quantize_text_params,
    stable_hash,
    text_encoder_apply,
    tokenize_batch,
    vae_decode,
    vae_encode,
)
from repro_torch.diffusion.lora import (
    fold_lora,
    fold_text_lora,
    init_lora,
    init_text_lora,
    quantize_lora,
    quantize_text_lora,
    randomize_lora,
    stack_loras,
    stack_text_loras,
)
from repro_torch.diffusion.mmdit import (
    controlnet_apply,
    init_controlnet,
    init_mmdit,
    mmdit_apply,
    mmdit_apply_seq_sharded,
    quantize_mmdit_params,
    seq_shard_divisor,
)
from repro_torch.diffusion.sampler import (
    combine_cfg_rows,
    denoise_step,
    denoise_step_,
    donate_buffers_enabled,
    fold_cfg,
    fused_cfg_velocity,
)
from repro_torch.weights import to_device

_TOY_VOCAB = 512


def _split_rows(val: torch.Tensor, sizes: List[int], dim: int = 0
                ) -> List[torch.Tensor]:
    """Split a stacked batch back into per-request chunks along ``dim``."""
    return list(torch.split(val, sizes, dim=dim))


def _shard_rows(mesh: Any, fn: Callable[..., torch.Tensor],
                replicas: List[Dict[str, Any]], args: Sequence[Any],
                dims: Sequence[int], out_dim: int = 0) -> torch.Tensor:
    """Row data parallelism over a submesh: each tensor of ``args`` splits
    into k parts along its entry of ``dims`` (a ``None`` passes to every
    slot as it is), slot i computes ``fn(replicas[i], *its parts)``, and
    the results are gathered on the home slot along ``out_dim``."""
    parts = [[None] * mesh.size if a is None else mesh.scatter(a, d)
             for a, d in zip(args, dims)]
    return mesh.gather([fn(r, *xs) for r, *xs in zip(replicas, *parts)],
                       dim=out_dim)


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


def _patch_ids(kw: Dict[str, Any]) -> Tuple[str, ...]:
    return tuple(p.model_id for p in kw.get("_patches") or [])


def _fold_direct(model: Model, comps: Dict[str, Any],
                 patches: Optional[Sequence[Model]],
                 device: torch.device) -> Dict[str, Any]:
    """Legacy direct-call route: fold a request's ``_patches`` (adapter
    models) into a copy of the components.  The serving runtime never
    passes uniform patches this way; it folds through the backend's
    ``(model_id, patch_ids)`` cache instead."""
    if not patches:
        return comps
    return model.fold_patches(comps, list(patches),
                              [p.load(device) for p in patches])


_ML_STACK_CACHE_CAP = 16


def _cached_lora_stack(comps: Dict[str, Any], order: Tuple[str, ...],
                       adapters: Dict[str, Dict[str, Any]],
                       cache_key: str = "_ml_stacks",
                       field: str = "lora", build: Any = stack_loras) -> Any:
    """Grouped adapter stacks, cached per adapter ordering on the
    components dict (small LRU: a stack is a device-resident concat of the
    pool's decoded factors, rebuilt only when the tenant mix of a batch
    changes)."""
    cache = comps.setdefault(cache_key, OrderedDict())
    if order in cache:
        cache.move_to_end(order)
        return cache[order]
    stack = build([adapters[pid][field] for pid in order])
    cache[order] = stack
    while len(cache) > _ML_STACK_CACHE_CAP:
        cache.popitem(last=False)
    return stack


def _multilora_groups(batch_kwargs: List[Dict[str, Any]],
                      adapters: Dict[str, Dict[str, Any]],
                      field: str = "lora") -> Optional[Tuple]:
    """Per-request adapter grouping for a mixed batch: returns
    ``(order, per_request_idx)`` with ``order`` the distinct adapter ids
    (first-appearance order) and ``per_request_idx[i]`` the group of
    request i (-1 = unpatched), or ``None`` when the batch is outside the
    grouped form (a request with >1 patch, or no adapters at all)."""
    patch_ids = [_patch_ids(kw) for kw in batch_kwargs]
    if any(len(ps) > 1 for ps in patch_ids):
        return None
    order: List[str] = []
    for ps in patch_ids:
        for pid in ps:
            if pid not in order and field in adapters.get(pid, {}):
                order.append(pid)
    if not order:
        return None
    g_of = {pid: g for g, pid in enumerate(order)}
    per_req = [g_of.get(ps[0], -1) if ps else -1 for ps in patch_ids]
    return tuple(order), per_req


def _row_idx(per_req: Sequence[int], sizes: Sequence[int],
             device: torch.device) -> torch.Tensor:
    """Per-row int32 adapter index, built host-side in ONE transfer."""
    return torch.from_numpy(np.repeat(
        np.asarray(per_req, np.int32), sizes)).to(device)


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
    supports_multilora = True

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
        return {"params": quantize_text_params(params), "device": dev}

    def fold_patches(
        self,
        components: Dict[str, Any],
        patches: List[Model],
        patch_components: List[Dict[str, Any]],
    ) -> Dict[str, Any]:
        params = components["params"]
        for pc in patch_components:
            if "text_lora" in pc:
                params = fold_text_lora(params, pc["text_lora"])
        # quantize-on-fold: the backend's fold cache stores this copy, so it
        # carries the active REPRO_QUANT form even when the base components
        # predate a mode flip
        return {**components, "params": quantize_text_params(params)}

    def execute_batch_multilora(
        self,
        model_components: Dict[str, Any],
        batch_kwargs: List[Dict[str, Any]],
        adapters: Dict[str, Dict[str, Any]],
    ) -> Optional[List[Dict[str, Any]]]:
        """One forward for a batch mixing text adapters: the last layer's
        ``wo`` applies each row's adapter through the grouped kernel."""
        groups = _multilora_groups(batch_kwargs, adapters, field="text_lora")
        if groups is None:
            return None
        order, per_req = groups
        stack = _cached_lora_stack(
            model_components, order, adapters, cache_key="_ml_text_stacks",
            field="text_lora", build=stack_text_loras)
        dev = model_components["device"]
        cfg = self.family.toy
        ids = tokenize_batch([kw["prompt"] for kw in batch_kwargs],
                             _TOY_VOCAB, cfg.text_tokens, dev)
        emb = text_encoder_apply(model_components["params"], ids, n_heads=4,
                                 lora_stack=stack,
                                 lora_idx=torch.tensor(per_req, dtype=torch.int32,
                                                       device=dev))
        return [{"prompt_embeds": emb[i:i + 1]} for i in range(len(batch_kwargs))]

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
            # grouped multi-LoRA pricing: one target (last layer's wo),
            # two skinny matmuls per row, bf16 A/B factors per adapter
            lora_rank=8,
            lora_flops_per_rank=4.0 * f.text_tokens * 4096,
            lora_bytes_per_adapter=4.0 * 4096 * 8,
            quantizable=True,            # qdense projections (REPRO_QUANT)
        )


class DiffusionBackbone(Model):
    """One denoising step of the base diffusion model (CFG included).
    The ControlNet residuals are a deferred input (§7.3)."""

    scan_role = "backbone"
    supports_multilora = True

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
        return {"params": quantize_mmdit_params(params), "cfg": cfg,
                "device": dev}

    def fold_patches(
        self,
        components: Dict[str, Any],
        patches: List[Model],
        patch_components: List[Dict[str, Any]],
    ) -> Dict[str, Any]:
        """LoRA fold, done ONCE per (model, patch set) by the backend.  The
        folded copy the backend caches carries the active ``REPRO_QUANT``
        form (quantize-on-fold)."""
        params = components["params"]
        for pc in patch_components:
            params = fold_lora(params, pc["lora"])
        return {**components, "params": quantize_mmdit_params(params)}

    def velocity(
        self,
        model_components: Dict[str, Any],
        lat: torch.Tensor,
        t: torch.Tensor,
        emb: torch.Tensor,
        res: Optional[torch.Tensor],
        guidance: torch.Tensor,
        lora: Optional[Tuple[Dict[str, Any], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """The guided velocity of one stacked forward: the one routine the
        per-step node and the fused segment both call.  ``t`` and
        ``guidance`` are f32 ``[B]`` vectors on the components' device.

        ``lora = (stack, idx)`` runs the grouped multi-adapter forward:
        ``stack`` from :func:`stack_loras` and ``idx`` the int32 ``[B]``
        adapter of each latent row (-1 = none), doubled alongside the rows
        for one-pass CFG."""
        cfg: DiTConfig = model_components["cfg"]
        params = model_components["params"]
        stack = idx = None
        if lora is not None:
            stack, idx = lora
            if self.family.uses_cfg:
                idx = torch.cat([idx, idx])

        def apply(p, l, tt, e, r):
            return mmdit_apply(p, cfg, l, tt, e, r, lora_stack=stack,
                               lora_idx=idx)

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
        residual stacks; timesteps and guidance become per-item vectors.
        Requests with different ``_patches`` (direct callers only) run one
        by one, each with its adapter folded in."""
        dev = model_components["device"]
        patch_sets = [_patch_ids(kw) for kw in batch_kwargs]
        if any(ps != patch_sets[0] for ps in patch_sets[1:]):
            return self._execute_sequential(model_components, batch_kwargs)
        stacked = self._stack_batch(dev, batch_kwargs)
        if stacked is None:
            return self._execute_sequential(model_components, batch_kwargs)
        comps = _fold_direct(self, model_components,
                             batch_kwargs[0].get("_patches"), dev)
        lat, emb, t, res, guidance, sizes = stacked
        v = self.velocity(comps, lat, t, emb, res, guidance)
        return [{"velocity": chunk} for chunk in _split_rows(v, sizes)]

    def execute_batch_multilora(
        self,
        model_components: Dict[str, Any],
        batch_kwargs: List[Dict[str, Any]],
        adapters: Dict[str, Dict[str, Any]],
    ) -> Optional[List[Dict[str, Any]]]:
        """One stacked forward for a batch MIXING adapters: per-row grouped
        LoRA against the shared base params (the unfolded serving mode),
        with no per-tenant fold and no parameter mutation."""
        groups = _multilora_groups(batch_kwargs, adapters)
        if groups is None:
            return None
        dev = model_components["device"]
        stacked = self._stack_batch(dev, batch_kwargs)
        if stacked is None:
            return None
        order, per_req = groups
        lat, emb, t, res, guidance, sizes = stacked
        stack = _cached_lora_stack(model_components, order, adapters)
        v = self.velocity(model_components, lat, t, emb, res, guidance,
                          lora=(stack, _row_idx(per_req, sizes, dev)))
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

    def execute_batch_sharded(
        self,
        model_components: List[Dict[str, Any]],
        batch_kwargs: List[Dict[str, Any]],
        mesh: Any,
    ) -> Optional[List[Dict[str, Any]]]:
        """The stacked forward sharded over the submesh's slots, in one of
        two modes chosen by shape:

        * **latent/CFG-branch data parallelism**: the CFG pair is folded
          onto the batch axis (cond rows, then null rows) and the rows
          split across the slots: at k=2/B=1 the conditional and
          unconditional branches run on different slots (the paper's
          latent parallelism), at larger B whole requests spread out.
          Per-item guidance stays a [B] vector applied after the gather,
          so mixed guidance scales remain fusable.
        * **sequence sharding**: when the row count does not divide by k
          (one CFG pair on a k=4 submesh), the image tokens shard instead
          (``mmdit_apply_seq_sharded``), with per-layer K/V all-gathers
          keeping joint attention exact.

        Returns None when neither mode fits (the backend falls back to the
        single-device stacked forward)."""
        if any(kw.get("_patches") for kw in batch_kwargs):
            return None      # backend lifts uniform patches before us
        stacked = self._stack_batch(mesh.home, batch_kwargs)
        if stacked is None:
            return None
        lat, emb, t, res, guidance, sizes = stacked
        cfg: DiTConfig = model_components[0]["cfg"]
        if self.family.uses_cfg:     # fold CFG onto the batch axis first
            lat, t, emb, res = fold_cfg(lat, t, emb, res)
        k = mesh.size
        if lat.shape[0] % k == 0:
            v = _shard_rows(mesh, lambda c, l, tt, e, r: mmdit_apply(
                c["params"], cfg, l, tt, e, r), model_components,
                (lat, t, emb, res), (0, 0, 0, 1))
        elif seq_shard_divisor(cfg, k):
            v = mmdit_apply_seq_sharded([c["params"] for c in model_components],
                                        cfg, lat, t, emb, res, mesh)
        else:
            return None
        if self.family.uses_cfg:
            v = combine_cfg_rows(v, guidance)
        return [{"velocity": chunk} for chunk in _split_rows(v, sizes)]

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
            # grouped multi-LoRA pricing (§5.1 extended): 4 img-stream
            # targets × n_layers, two skinny matmuls per row per rank;
            # per-adapter HBM traffic is the bf16 A/B factor stream
            lora_rank=8,
            lora_flops_per_rank=16.0 * f.n_layers_real * f.image_tokens
            * f.d_model_real,
            lora_bytes_per_adapter=16.0 * f.n_layers_real * f.d_model_real * 8,
            # stream projections quantize (REPRO_QUANT): the profiles price
            # int8 forwards at the doubled issue rate and the halved weight
            # stream
            quantizable=True,
        )

    def build_segment(self, controlnets: List[Model],
                      n_steps: int) -> "DenoiseSegment":
        """Factory the :class:`~repro_torch.core.passes.SegmentFusionPass`
        calls to materialize a fused multi-step op for a recognized chain."""
        return DenoiseSegment(self, controlnets, n_steps)


class ControlNet(Model):
    """The ControlNet branch of one denoising step: per-layer residuals for
    the backbone's deferred ``controlnet_residuals`` input (§7.3), from the
    noisy latents, the VAE-encoded reference image, the prompt and the
    step's time."""

    scan_role = "controlnet"

    def __init__(self, family: DiffusionFamily, variant: int = 1,
                 weights: Optional[Dict[str, Any]] = None) -> None:
        self.family = family
        self.variant = variant
        self.weights = weights
        super().__init__(model_id=f"controlnet{variant}:{family.name}")

    def setup_io(self) -> None:
        self.add_input("latents", TensorType())
        self.add_input("cond_latents", TensorType())
        self.add_input("prompt_embeds", TensorType())
        self.add_input("t", float)
        self.add_output("controlnet_residuals", TensorType())

    def load(self, device: Any = None) -> Dict[str, Any]:
        """Draws the branch on the device (or moves the caller's
        ``weights``) and quantizes its stream projections per the active
        ``REPRO_QUANT`` mode; ``zero_proj`` and the embeddings stay as
        they are, as in the JAX package."""
        dev = _device(device)
        cfg = self.family.toy
        if self.weights is not None:
            params = to_device(self.weights, dev)
        else:
            params = init_controlnet(_generator(dev, self.model_id), cfg)
        return {"params": quantize_mmdit_params(params), "cfg": cfg,
                "device": dev}

    @staticmethod
    def residuals(model_components: Dict[str, Any], lat: torch.Tensor,
                  cond: torch.Tensor, t: torch.Tensor,
                  emb: torch.Tensor) -> torch.Tensor:
        """The ``[n_layers, B, Ti, d]`` residual stack of one stacked
        forward: the one routine the per-step node and the fused segment
        both call.  ``t`` is an f32 ``[B]`` vector on the components'
        device."""
        return controlnet_apply(model_components["params"],
                                model_components["cfg"], lat, cond, t, emb)

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        return self.execute_batch(model_components, [kw])[0]

    @staticmethod
    def _stack(dev: torch.device,
               batch_kwargs: List[Dict[str, Any]]) -> Optional[Tuple]:
        """Stack a cross-request batch onto ``dev``: (lat, cond, t, emb,
        sizes), in :meth:`residuals`' order, or None when latent shapes
        disagree."""
        lats = [kw["latents"] for kw in batch_kwargs]
        if any(l.shape[1:] != lats[0].shape[1:] for l in lats[1:]):
            return None
        sizes = [int(l.shape[0]) for l in lats]

        def cat(name):
            return torch.cat([kw[name].to(dev) for kw in batch_kwargs], dim=0)

        t = _f32_rows([float(kw["t"]) for kw in batch_kwargs], sizes, dev)
        return (cat("latents"), cat("cond_latents"), t, cat("prompt_embeds"),
                sizes)

    def execute_batch(
        self, model_components: Dict[str, Any], batch_kwargs: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Stacked cross-request forward; the residuals come back
        layer-major, so each request's rows are split off axis 1."""
        stacked = self._stack(model_components["device"], batch_kwargs)
        if stacked is None:
            return self._execute_sequential(model_components, batch_kwargs)
        *args, sizes = stacked
        res = self.residuals(model_components, *args)
        return [{"controlnet_residuals": chunk}
                for chunk in _split_rows(res, sizes, dim=1)]

    def execute_batch_sharded(
        self,
        model_components: List[Dict[str, Any]],
        batch_kwargs: List[Dict[str, Any]],
        mesh: Any,
    ) -> Optional[List[Dict[str, Any]]]:
        """Batch-axis data parallelism for the ControlNet branch: requests
        split across the slots; the layer-major residual stack comes back
        gathered on its batch axis (axis 1)."""
        if any(kw.get("_patches") for kw in batch_kwargs):
            return None
        stacked = self._stack(mesh.home, batch_kwargs)
        if stacked is None or sum(stacked[-1]) % mesh.size:
            return None
        *args, sizes = stacked
        res = _shard_rows(mesh, self.residuals, model_components, args,
                          (0, 0, 0, 0), out_dim=1)
        return [{"controlnet_residuals": chunk}
                for chunk in _split_rows(res, sizes, dim=1)]

    def cost(self) -> ModelCost:
        f = self.family
        return ModelCost(
            flops_per_item=f.controlnet_step_flops(),
            param_bytes=f.controlnet_bytes(),
            act_io_bytes=6.0 * f.n_layers_real * (f.image_tokens + f.text_tokens)
            * f.d_model_real,
            output_bytes=f.controlnet_residual_bytes(),
            max_parallelism=2,           # batch-axis data parallelism
            max_batch=8,
            calls_per_request=f.denoise_steps,
            quantizable=True,            # same stream projections as MMDiT
        )


class VAEDecode(Model):
    # decode of batch N may ride an executor still running batch N+1's
    # denoise segment (REPRO_OVERLAP): stateless and without patches.  The
    # coordinator prices its exposed remainder; the executor still runs
    # and synchronises it on the one stream, after the segment
    overlappable = True

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

    def execute_batch_sharded(
        self,
        model_components: List[Dict[str, Any]],
        batch_kwargs: List[Dict[str, Any]],
        mesh: Any,
    ) -> Optional[List[Dict[str, Any]]]:
        """Replicated-weight parallel decode: the VAE params live on every
        slot, latent rows split across them."""
        lats = [kw["latents"] for kw in batch_kwargs]
        if any(l.shape[1:] != lats[0].shape[1:] for l in lats[1:]):
            return None
        sizes = [int(l.shape[0]) for l in lats]
        if sum(sizes) % mesh.size:
            return None
        lat = torch.cat([l.to(mesh.home) for l in lats], dim=0)
        img = _shard_rows(mesh, lambda c, l: vae_decode(c["params"], l),
                          model_components, (lat,), (0,))
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


class VAEEncode(Model):
    """Reference-image encoder.  It shares the VAE's ``model_id`` (and so
    the executor's cached components) with :class:`VAEDecode`, so its
    ``load`` gives exactly the decoder's components, from the same
    ``weights``."""

    def __init__(self, family: DiffusionFamily,
                 weights: Optional[Dict[str, Any]] = None) -> None:
        self.family = family
        self.weights = weights
        super().__init__(model_id=f"vae:{family.name}")

    def setup_io(self) -> None:
        self.add_input("image", Image)
        self.add_output("cond_latents", TensorType())

    def load(self, device: Any = None) -> Dict[str, Any]:
        return VAEDecode(self.family, self.weights).load(device)

    def _as_tensor(self, img: Any, dev: torch.device) -> torch.Tensor:
        """The image as f32 ``[B, H, W, 3]`` on ``dev``; an input without a
        shape (the JAX package's stand-in for a PIL image) becomes a zero
        image of the family's pixel size."""
        if not hasattr(img, "shape"):
            cfg = self.family.toy
            return torch.zeros((1, cfg.latent_size * 8, cfg.latent_size * 8, 3),
                               device=dev)
        return torch.as_tensor(img, dtype=torch.float32, device=dev)

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        return self.execute_batch(model_components, [kw])[0]

    def execute_batch(
        self, model_components: Dict[str, Any], batch_kwargs: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        dev = model_components["device"]
        imgs = [self._as_tensor(kw["image"], dev) for kw in batch_kwargs]
        if any(i.shape[1:] != imgs[0].shape[1:] for i in imgs[1:]):
            return self._execute_sequential(model_components, batch_kwargs)
        sizes = [int(i.shape[0]) for i in imgs]
        lat = vae_encode(model_components["params"], torch.cat(imgs, dim=0))
        return [{"cond_latents": chunk} for chunk in _split_rows(lat, sizes)]

    def execute_batch_sharded(
        self,
        model_components: List[Dict[str, Any]],
        batch_kwargs: List[Dict[str, Any]],
        mesh: Any,
    ) -> Optional[List[Dict[str, Any]]]:
        """Replicated-weight parallel encode (mirror of VAEDecode)."""
        imgs = [self._as_tensor(kw["image"], mesh.home) for kw in batch_kwargs]
        if any(i.shape[1:] != imgs[0].shape[1:] for i in imgs[1:]):
            return None
        sizes = [int(i.shape[0]) for i in imgs]
        if sum(sizes) % mesh.size:
            return None
        lat = _shard_rows(mesh, lambda c, i: vae_encode(c["params"], i),
                          model_components, (torch.cat(imgs, dim=0),), (0,))
        return [{"cond_latents": chunk} for chunk in _split_rows(lat, sizes)]

    def cost(self) -> ModelCost:
        c = VAEDecode(self.family).cost()
        return ModelCost(c.flops_per_item, c.param_bytes, c.act_io_bytes,
                         self.family.latent_bytes(),
                         max_parallelism=c.max_parallelism, max_batch=16)


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


class ResidualCombine(Model):
    """Sum two ControlNets' residual stacks — trivial, inline on the
    coordinator, on the stacks' own device."""

    trivial = True
    scan_role = "combine"

    def __init__(self, family: DiffusionFamily) -> None:
        self.family = family
        super().__init__(model_id="residual_combine")

    def setup_io(self) -> None:
        self.add_input("a", TensorType())
        self.add_input("b", TensorType())
        self.add_output("controlnet_residuals", TensorType())

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        return {"controlnet_residuals": kw["a"] + kw["b"]}

    def cost(self) -> ModelCost:
        return ModelCost(1e6, 0, 1e6,
                         self.family.controlnet_residual_bytes(), max_batch=64)


class DenoiseSegment(Model):
    """A fused run of S consecutive denoising steps — ONE dispatch.

    Built by :class:`~repro_torch.core.passes.SegmentFusionPass` from a
    recognized ``ControlNet* → ResidualCombine* → DiffusionBackbone →
    DenoiseStep`` chain.  Each step calls each ControlNet's own
    :meth:`ControlNet.residuals` (summed in the chain's order, as the
    combine nodes sum them), the backbone's own
    :meth:`DiffusionBackbone.velocity` and the shared
    :func:`~repro_torch.diffusion.sampler.denoise_step`, so a segment's
    output equals the unfused chain's bit for bit.

    The step schedule travels in the NODE inputs (``t_mid``/``t_cur``/
    ``t_next`` tuples + ``guidance``), not in the op: two workflows with
    different step counts share one ``model_id``, and cross-request
    batches may mix schedules.  The runtime executes segments in
    load-adaptive chunks via the reserved ``_seg_start`` / ``_seg_steps``
    kwargs.  LoRA patches fold into the backbone params once per placement;
    a batch mixing tenants runs every step's forward with per-row adapters
    (:meth:`execute_batch_multilora`); the ControlNet residuals reach the
    backbone on both routes.
    """

    is_segment = True
    supports_multilora = True

    def __init__(self, backbone: DiffusionBackbone,
                 controlnets: Sequence[ControlNet], n_steps: int) -> None:
        self.backbone = backbone
        self.cns = list(controlnets)
        self.family = backbone.family
        self.n_steps = int(n_steps)
        super().__init__(model_id="segment:" + backbone.model_id + "".join(
            f"+{cn.model_id}" for cn in self.cns))

    def setup_io(self) -> None:
        self.add_input("latents", TensorType())
        self.add_input("prompt_embeds", TensorType())
        if self.cns:
            self.add_input("cond_latents", TensorType())
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
        # ``donate`` (REPRO_DONATE, read at load): ``_run`` updates the
        # stacked carry in place
        return {"backbone": self.backbone.load(device),
                "cns": [cn.load(device) for cn in self.cns],
                "donate": donate_buffers_enabled()}

    def fold_patches(
        self,
        components: Dict[str, Any],
        patches: List[Model],
        patch_components: List[Dict[str, Any]],
    ) -> Dict[str, Any]:
        folded = self.backbone.fold_patches(
            components["backbone"], patches, patch_components)
        return {**components, "backbone": folded}

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
             emb: torch.Tensor, cond: Optional[torch.Tensor],
             lora: Optional[Tuple] = None,
             velocity: Optional[Callable[..., torch.Tensor]] = None
             ) -> torch.Tensor:
        """``steps`` Euler steps of the stacked batch: each step's guided
        velocity ``velocity(lat, t, guidance)``, then the shared update.
        The velocity is one device's (:meth:`_velocity`: the ControlNets'
        residuals at the step's time and one guided backbone forward, with
        per-row adapters when ``lora`` is given) unless the caller passes
        another (the sharded segment's :meth:`_sharded_velocity`).

        ``lat`` must be a tensor the segment owns (``_stack``'s copy): under
        ``comps["donate"]`` every step updates it in place."""
        if velocity is None:
            velocity = self._velocity(comps, emb, cond, lora)
        step = denoise_step_ if comps.get("donate") else denoise_step
        dev = lat.device
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
            lat = step(lat, velocity(lat, t, guidance), tc, tn)
        return lat

    def _residuals(self, comps: Dict[str, Any], lat: torch.Tensor,
                   cond: Optional[torch.Tensor], t: torch.Tensor,
                   emb: torch.Tensor) -> Optional[torch.Tensor]:
        """The ControlNets' residual stacks at one step, summed in the
        chain's order (as the combine nodes sum them); None without
        ControlNets."""
        res = None
        for cn, cn_comps in zip(self.cns, comps["cns"]):
            r = cn.residuals(cn_comps, lat, cond, t, emb)
            res = r if res is None else res + r
        return res

    def _velocity(self, comps: Dict[str, Any], emb: torch.Tensor,
                  cond: Optional[torch.Tensor],
                  lora: Optional[Tuple] = None) -> Callable[..., torch.Tensor]:
        """One device's step velocity: the residuals, then one guided
        backbone forward (per-row adapters when ``lora`` is given)."""
        def velocity(lat, t, guidance):
            return self.backbone.velocity(
                comps["backbone"], lat, t, emb,
                self._residuals(comps, lat, cond, t, emb), guidance, lora=lora)
        return velocity

    def _sharded_velocity(self, replicas: List[Dict[str, Any]],
                          emb: torch.Tensor, cond: Optional[torch.Tensor],
                          mesh: Any) -> Callable[..., torch.Tensor]:
        """The step velocity over the submesh's slots.  The CFG pair folds
        onto the batch axis and the mode follows the shape, as in the JAX
        package: row parallelism when the folded rows divide k, else
        sequence sharding with per-layer K/V all-gathers.

        The ControlNets see the COND embedding on every row (the unfused
        graph computes one residual set and reuses it for both CFG
        branches).  Under row parallelism their rows are duplicated with
        the CFG pair and split with the rows, so each slot computes the
        residuals of its own rows; under sequence sharding they run once,
        on the home slot, on the latent rows, and each shard takes its
        token slice of the doubled stack."""
        cfg: DiTConfig = replicas[0]["backbone"]["cfg"]
        uses_cfg = self.family.uses_cfg

        def slot(comps, lat, cnd, t, e, e_cn):
            return mmdit_apply(comps["backbone"]["params"], cfg, lat, t, e,
                               self._residuals(comps, lat, cnd, t, e_cn))

        def velocity(lat, t, guidance):
            if lat.shape[0] * (2 if uses_cfg else 1) % mesh.size == 0:
                lat2, t2, emb2, _ = (fold_cfg(lat, t, emb) if uses_cfg
                                     else (lat, t, emb, None))
                cond2 = emb_cn = None
                if self.cns:
                    cond2 = torch.cat([cond, cond]) if uses_cfg else cond
                    emb_cn = torch.cat([emb, emb]) if uses_cfg else emb
                v = _shard_rows(mesh, slot, replicas,
                                (lat2, cond2, t2, emb2, emb_cn), (0,) * 5)
            else:
                res = self._residuals(replicas[0], lat, cond, t, emb)
                v = mmdit_apply_seq_sharded(
                    [c["backbone"]["params"] for c in replicas], cfg,
                    *(fold_cfg(lat, t, emb, res) if uses_cfg
                      else (lat, t, emb, res)), mesh)
            return combine_cfg_rows(v, guidance) if uses_cfg else v
        return velocity

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        return self.execute_batch(model_components, [kw])[0]

    def clamp_parallelism(self, batch_size: int, k: int) -> int:
        """Largest k' <= k with a sharded mode: the folded CFG rows divide
        k' (row DP), or the patch grid divides k' (sequence sharding).  The
        scheduler consults it on every plane, so the port's dispatches (and
        the simulator's numbers) follow the JAX package's;
        ``ShardedBackend`` runs the batch over k' slots, ``LocalBackend``
        on its one device."""
        rows = batch_size * (2 if self.family.uses_cfg else 1)
        for j in range(k, 0, -1):
            if rows % j == 0 or seq_shard_divisor(self.family.toy, j):
                return j
        return 1

    def _segment_steps(self, batch_kwargs: List[Dict[str, Any]]
                       ) -> Optional[int]:
        """The chunk length every request of the batch covers, or None when
        the batch cannot be stacked (shapes or chunk lengths disagree)."""
        names = ("latents", "prompt_embeds") + (
            ("cond_latents",) if self.cns else ())
        chunks = [self._chunk_of(kw) for kw in batch_kwargs]
        steps = chunks[0][1]
        if (any(kw[n].shape[1:] != batch_kwargs[0][n].shape[1:]
                for n in names for kw in batch_kwargs[1:])
                or any(c[1] != steps for c in chunks[1:])):
            return None
        return steps

    def _stack(self, dev: torch.device,
               batch_kwargs: List[Dict[str, Any]]) -> Tuple:
        """(lat, emb, cond, sizes) on ``dev``; ``cond`` is None without
        ControlNets.  ``torch.cat`` always copies, even one request's
        tensor already on ``dev``: ``lat`` is the segment's own carry, so
        a donated run never writes a datastore, caller or cache tensor."""
        def cat(name):
            return torch.cat([kw[name].to(dev) for kw in batch_kwargs], dim=0)

        sizes = [int(kw["latents"].shape[0]) for kw in batch_kwargs]
        cond = cat("cond_latents") if self.cns else None
        return cat("latents"), cat("prompt_embeds"), cond, sizes

    def execute_batch(
        self, model_components: Dict[str, Any], batch_kwargs: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        steps = self._segment_steps(batch_kwargs)
        patch_sets = [_patch_ids(kw) for kw in batch_kwargs]
        if steps is None or any(ps != patch_sets[0] for ps in patch_sets[1:]):
            return self._execute_sequential(model_components, batch_kwargs)
        if steps <= 0:
            return [{"latents": kw["latents"]} for kw in batch_kwargs]
        dev = model_components["backbone"]["device"]
        lat, emb, cond, sizes = self._stack(dev, batch_kwargs)
        comps = _fold_direct(self, model_components,
                             batch_kwargs[0].get("_patches"), dev)
        out = self._run(comps, batch_kwargs, sizes, steps, lat, emb, cond)
        return [{"latents": chunk} for chunk in _split_rows(out, sizes)]

    def execute_batch_multilora(
        self,
        model_components: Dict[str, Any],
        batch_kwargs: List[Dict[str, Any]],
        adapters: Dict[str, Dict[str, Any]],
    ) -> Optional[List[Dict[str, Any]]]:
        """The whole chunk for a batch mixing tenants: cross-tenant
        requests share the segment, and every step applies per-row
        adapters against the shared base params."""
        groups = _multilora_groups(batch_kwargs, adapters)
        steps = self._segment_steps(batch_kwargs)
        if groups is None or steps is None or steps <= 0:
            return None
        order, per_req = groups
        dev = model_components["backbone"]["device"]
        lat, emb, cond, sizes = self._stack(dev, batch_kwargs)
        stack = _cached_lora_stack(model_components, order, adapters)
        out = self._run(model_components, batch_kwargs, sizes, steps, lat, emb,
                        cond, lora=(stack, _row_idx(per_req, sizes, dev)))
        return [{"latents": chunk} for chunk in _split_rows(out, sizes)]

    def execute_batch_sharded(
        self,
        model_components: List[Dict[str, Any]],
        batch_kwargs: List[Dict[str, Any]],
        mesh: Any,
    ) -> Optional[List[Dict[str, Any]]]:
        """The whole chunk over the submesh's slots: every step folds the
        CFG pair onto the batch axis and shards it (rows, or the image
        tokens: :meth:`_sharded_velocity`); the Euler update runs on the
        home slot.  Declines (None) when neither the folded rows nor the
        patch grid divide k; the backend then falls back to the
        single-device segment."""
        if any(kw.get("_patches") for kw in batch_kwargs):
            return None      # backend lifts uniform patches before us
        steps = self._segment_steps(batch_kwargs)
        if steps is None or steps <= 0:
            return None
        rows = (sum(int(kw["latents"].shape[0]) for kw in batch_kwargs)
                * (2 if self.family.uses_cfg else 1))
        if rows % mesh.size and not seq_shard_divisor(self.family.toy,
                                                      mesh.size):
            return None
        # inputs may lie on a previous placement (the home device, or
        # another submesh after a recovery re-dispatch of a chunked
        # segment): _stack copies them onto this submesh's home slot
        lat, emb, cond, sizes = self._stack(mesh.home, batch_kwargs)
        out = self._run(model_components[0], batch_kwargs, sizes, steps, lat,
                        emb, cond, velocity=self._sharded_velocity(
                            model_components, emb, cond, mesh))
        return [{"latents": chunk} for chunk in _split_rows(out, sizes)]

    def cost(self) -> ModelCost:
        """PER-STEP terms (the backbone and its ControlNets) with
        ``steps_per_call`` carrying the segment length; only the final
        latent leaves the device per chunk."""
        b = self.backbone.cost()
        flops, params, act = b.flops_per_item, b.param_bytes, b.act_io_bytes
        for cn in self.cns:          # summed in the JAX package's order
            c = cn.cost()
            flops += c.flops_per_item
            params += c.param_bytes
            act += c.act_io_bytes
        return ModelCost(
            flops_per_item=flops,
            param_bytes=params,
            act_io_bytes=act,
            output_bytes=self.family.latent_bytes(),
            max_parallelism=b.max_parallelism,
            max_batch=b.max_batch,
            calls_per_request=1,
            steps_per_call=self.n_steps,
            # per-row adapters apply inside every step: inherit the
            # backbone's per-step multi-LoRA pricing terms
            lora_rank=b.lora_rank,
            lora_flops_per_rank=b.lora_flops_per_rank,
            lora_bytes_per_adapter=b.lora_bytes_per_adapter,
            # the backbone and its ControlNets all quantize, so the segment
            # prices quantized too
            quantizable=True,
        )


class LoRAAdapter(Model):
    """Weight-patching adapter (attached via ``backbone.add_patch``).

    ``load(device)`` draws the backbone factors (``"lora"``, B randomized
    so the adapter changes the image) and the text-encoder companion
    (``"text_lora"``) on the device from a generator seeded with the model
    id, or moves the converted ``weights`` (a ``{"lora", "text_lora"}``
    tree) a caller handed in."""

    def __init__(self, family: DiffusionFamily, name: str = "style",
                 rank: int = 8, param_bytes: float = 886 * 2**20,
                 weights: Optional[Dict[str, Any]] = None) -> None:
        self.family = family
        self.rank = rank
        self.weights = weights
        self._param_bytes = param_bytes
        super().__init__(model_id=f"lora:{name}:{family.name}")

    def setup_io(self) -> None:
        self.add_output("adapter_weights", TensorType())

    def load(self, device: Any = None) -> Dict[str, Any]:
        dev = _device(device)
        if self.weights is not None:
            comps = to_device(self.weights, dev)
        else:
            gen = _generator(dev, self.model_id)
            cfg = self.family.toy
            comps = {"lora": randomize_lora(gen, init_lora(gen, cfg,
                                                           rank=self.rank)),
                     "text_lora": init_text_lora(gen, cfg.text_dim,
                                                 rank=self.rank)}
        # quantized factors (REPRO_QUANT): the adapter pool's byte budget
        # sees the small form
        return {"lora": quantize_lora(comps["lora"]),
                "text_lora": quantize_text_lora(comps["text_lora"])}

    def execute(self, model_components: Dict[str, Any], **kw: Any) -> Dict[str, Any]:
        return {"adapter_weights": model_components["lora"]}

    def cost(self) -> ModelCost:
        return ModelCost(0, self._param_bytes, self._param_bytes,
                         self._param_bytes, max_batch=1)
