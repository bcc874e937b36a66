"""The ``Model`` base class — the unit of micro-serving (§4.1).

Model developers subclass :class:`Model` and implement exactly three
methods — ``setup_io()``, ``load()``, ``execute()`` — plus optionally
``cost()`` (used by the analytic latency profiles; see
:mod:`repro_torch.core.profiles`).  Workflow integration (``__call__`` tracing,
patch bookkeeping) lives entirely in the base class, mirroring Fig. 6 of the
paper.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.types import (
    Port,
    PortType,
    ValueRef,
    WorkflowTypeError,
    check_value,
    type_name,
    types_compatible,
)


class ModelCost:
    """Static cost description used by analytic profiles and the roofline.

    ``flops_per_item``  — FLOPs for one batch item at the model's nominal
                          input size;
    ``param_bytes``     — parameter footprint (what ``load()`` moves to HBM);
    ``act_io_bytes``    — activation bytes read+written per item (memory
                          roofline term);
    ``output_bytes``    — bytes produced per item (data-engine transfers);
    ``max_parallelism`` — ``k_max``: the maximum useful intra-node
                          parallelism (§5.2), profiled offline;
    ``max_batch``       — ``B_max``: profiled maximum useful batch (§5.1);
    ``calls_per_request`` — how many times a single request invokes this
                          model (e.g. #denoising steps for the backbone);
    ``steps_per_call``  — for segment models (fused denoise chains): how
                          many internal steps one full call runs.  The
                          per-step terms (``flops_per_item`` etc.) describe
                          ONE step; segment cost = S× per-step cost with
                          the fixed dispatch overhead paid once.

    Multi-adapter serving terms (all default 0 — no effect unless the
    model declares them):

    ``lora_rank``           — rank of the adapters this model serves;
    ``lora_flops_per_rank`` — extra FLOPs per item PER RANK the grouped
                              unfolded forward adds (the two skinny
                              matmuls x·A and (x·A)·B);
    ``lora_bytes_per_adapter`` — HBM bytes one resident adapter's decoded
                              A/B factors stream per forward (adapter-
                              count term for admission and pricing).
    """

    def __init__(
        self,
        flops_per_item: float,
        param_bytes: float,
        act_io_bytes: float,
        output_bytes: float,
        max_parallelism: int = 1,
        max_batch: int = 8,
        calls_per_request: int = 1,
        steps_per_call: int = 1,
        lora_rank: int = 0,
        lora_flops_per_rank: float = 0.0,
        lora_bytes_per_adapter: float = 0.0,
        quantizable: bool = False,
    ) -> None:
        self.flops_per_item = float(flops_per_item)
        self.param_bytes = float(param_bytes)
        self.act_io_bytes = float(act_io_bytes)
        self.output_bytes = float(output_bytes)
        self.max_parallelism = int(max_parallelism)
        self.max_batch = int(max_batch)
        self.calls_per_request = int(calls_per_request)
        self.steps_per_call = int(steps_per_call)
        self.lora_rank = int(lora_rank)
        self.lora_flops_per_rank = float(lora_flops_per_rank)
        self.lora_bytes_per_adapter = float(lora_bytes_per_adapter)
        # ``quantizable`` marks models whose matmul-dominated weights ride
        # the REPRO_QUANT side-structure (backbones, text encoders,
        # controlnets — not VAEs): analytic profiles scale their compute
        # and residency terms by the active quant mode's roofline factors.
        self.quantizable = bool(quantizable)


class Model(abc.ABC):
    """Base class every servable model/adapter subclasses.

    ``model_id`` identifies *loadable state*: two Model instances with the
    same ``model_id`` are interchangeable for scheduling, which is what makes
    cross-workflow model sharing possible (§5.1).
    """

    def __init__(self, model_id: Optional[str] = None, **kwargs: Any) -> None:
        self.model_id: str = model_id or type(self).__name__
        self.init_kwargs = dict(kwargs)
        self._inputs: Dict[str, Port] = {}
        self._outputs: Dict[str, Port] = {}
        self._patches: List["Model"] = []
        self.setup_io()

    # ---------------------------------------------------------------- DSL
    def add_input(self, name: str, data_type: PortType, deferred: bool = False) -> None:
        self._inputs[name] = Port(name, data_type, deferred)

    def add_output(self, name: str, data_type: PortType) -> None:
        self._outputs[name] = Port(name, data_type)

    @property
    def inputs(self) -> Dict[str, Port]:
        return self._inputs

    @property
    def outputs(self) -> Dict[str, Port]:
        return self._outputs

    # ------------------------------------------------------------ patches
    def add_patch(self, patch: "Model") -> None:
        """Attach a weight-patching adapter (LoRA-class, §2.1)."""
        self._patches.append(patch)

    def rm_patch(self, patch: "Model") -> None:
        self._patches.remove(patch)

    @property
    def patches(self) -> List["Model"]:
        return list(self._patches)

    # ----------------------------------------------------- tracing support
    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        """Record a model invocation as a workflow node (Fig. 6 lines 9-13).

        Returns the node's output ``ValueRef``s — a single ref if the model
        declares one output, else a dict of refs.
        """
        from repro_torch.core.workflow import WorkflowContext, WorkflowNode

        workflow = WorkflowContext.get_current_workflow()
        if workflow is None:
            raise RuntimeError(
                f"{self.model_id} called outside of a Workflow scope; "
                "model invocations must happen while composing a workflow"
            )
        bound = self._bind_arguments(args, kwargs)
        self._typecheck_call(bound)
        node = WorkflowNode(op=self, inputs=bound)
        workflow.add_workflow_node(node)
        return node.get_outputs()

    def _bind_arguments(self, args: Any, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        names = list(self._inputs.keys())
        bound: Dict[str, Any] = {}
        if len(args) > len(names):
            raise WorkflowTypeError(
                f"{self.model_id}: got {len(args)} positional args but "
                f"declares only {len(names)} inputs {names}"
            )
        for name, value in zip(names, args):
            bound[name] = value
        for name, value in kwargs.items():
            if name in bound:
                raise WorkflowTypeError(
                    f"{self.model_id}: input '{name}' given positionally and by keyword"
                )
            bound[name] = value
        return bound

    def _typecheck_call(self, bound: Dict[str, Any]) -> None:
        for name, value in bound.items():
            port = self._inputs.get(name)
            if port is None:
                raise WorkflowTypeError(
                    f"{self.model_id}: unknown input '{name}' "
                    f"(declared: {sorted(self._inputs)})"
                )
            if isinstance(value, ValueRef):
                if not types_compatible(value.type, port.type):
                    raise WorkflowTypeError(
                        f"{self.model_id}.{name}: producer type "
                        f"{type_name(value.type)} incompatible with declared "
                        f"{type_name(port.type)}"
                    )
            elif value is not None:
                if not check_value(port.type, value):
                    raise WorkflowTypeError(
                        f"{self.model_id}.{name}: literal {value!r} does not "
                        f"satisfy declared type {type_name(port.type)}"
                    )
        for name, port in self._inputs.items():
            if name not in bound and not port.deferred:
                raise WorkflowTypeError(
                    f"{self.model_id}: missing required input '{name}'"
                )

    # -------------------------------------------------------- to implement
    @abc.abstractmethod
    def setup_io(self) -> None:
        """Declare typed inputs/outputs via add_input()/add_output()."""

    def load(self, device: Any = None) -> Dict[str, Any]:
        """Initialize model state on a device; returns components dict."""
        return {}

    def execute(self, model_components: Dict[str, Any], **kwargs: Any) -> Dict[str, Any]:
        """Run inference.  Must return a dict keyed by declared outputs."""
        raise NotImplementedError

    # --------------------------------------------------- batched execution
    def execute_batch(
        self, model_components: Dict[str, Any], batch_kwargs: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Run inference for several requests in ONE forward (§5.1).

        The default implementation stacks every ``TensorType`` input along
        the batch axis (axis 0), requires non-tensor inputs to agree across
        the batch, runs :meth:`execute` once, and splits ``TensorType``
        outputs back per request.  Models whose batch axis is not axis 0 on
        every port (e.g. the MMDiT backbone's layer-major ControlNet
        residuals) override this with a shape-aware version.

        Falls back to sequential per-request execution whenever the batch
        cannot be stacked soundly.  Overrides MUST route their fallbacks
        through :meth:`_execute_sequential` — it clears the
        ``_batch_was_stacked`` flag the executor backend reads for forward
        accounting.
        """
        if len(batch_kwargs) == 1:
            return [self.execute(model_components, **batch_kwargs[0])]
        stacked, sizes = self._stack_inputs(batch_kwargs)
        if stacked is None:
            return self._execute_sequential(model_components, batch_kwargs)
        out = self.execute(model_components, **stacked)
        return self._split_outputs(out, sizes)

    # Set by the executor backend before each execute_batch call and
    # cleared by _execute_sequential, so forward accounting reflects what
    # actually ran (one stacked forward vs N fallback forwards).
    _batch_was_stacked: bool = True

    def _execute_sequential(
        self, model_components: Dict[str, Any], batch_kwargs: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Per-request fallback when a batch cannot be stacked soundly."""
        self._batch_was_stacked = False
        return [self.execute(model_components, **kw) for kw in batch_kwargs]

    # -------------------------------------------- multi-adapter execution
    # True when the model can run one stacked forward for a batch whose
    # requests carry DIFFERENT weight patches (grouped multi-LoRA, §2.1):
    # the scheduler then stops partitioning batches by patch set, and the
    # backend routes mixed batches to :meth:`execute_batch_multilora`.
    supports_multilora: bool = False

    # ------------------------------------------------- pipeline overlap
    # True when this model's forward may be dispatched asynchronously
    # onto an executor that is still busy running a denoise segment
    # (REPRO_OVERLAP): its compute hides under the in-flight segment
    # window and the timeline only pays the EXPOSED remainder (see
    # ``LatencyProfile.exposed_cost``).  Safe for stateless post-stage
    # work like VAE decode — never for segment ops themselves.
    overlappable: bool = False

    def execute_batch_multilora(
        self,
        model_components: Dict[str, Any],
        batch_kwargs: List[Dict[str, Any]],
        adapters: Dict[str, Dict[str, Any]],
    ) -> Optional[List[Dict[str, Any]]]:
        """Run one stacked forward for a batch mixing adapters (§5.1).

        ``batch_kwargs`` keep their per-request ``_patches`` entries (the
        adapter :class:`Model` objects); ``adapters`` maps each patch
        ``model_id`` to its decoded components (from the backend's adapter
        pool), so implementations never call ``patch.load()`` themselves.
        Returns per-request outputs, or ``None`` to decline — the backend
        then falls back to the per-request fold path.
        """
        return None

    # ------------------------------------------------- sharded execution
    def clamp_parallelism(self, batch_size: int, k: int) -> int:
        """Largest parallelism ≤ ``k`` this model can actually use for a
        stacked batch of ``batch_size`` requests.  The scheduler consults
        this after its load-based choice so dispatched degrees are
        feasible by construction instead of silently falling back (e.g. a
        CFG pair cannot row-shard across 3 devices).  Default: accept."""
        return k

    def execute_batch_sharded(
        self,
        model_components: List[Dict[str, Any]],
        batch_kwargs: List[Dict[str, Any]],
        mesh: Any,
    ) -> Optional[List[Dict[str, Any]]]:
        """Run one stacked forward sharded over ``mesh`` (§5.2).

        The hook :class:`~repro_torch.core.executor.ShardedBackend` calls
        for a :class:`ScheduledBatch` that carries parallelism k>1; ``mesh``
        is the k-slot :class:`~repro_torch.core.mesh.Submesh` assembled from
        the batch's executors, and ``model_components`` arrive as one
        components tree per slot, in the submesh's order.  Implementations
        shard the stacked batch (or the token sequence) over the slots with
        the submesh's collectives, gather the outputs on its home slot and
        return per-request outputs, or ``None`` when this batch cannot be
        sharded soundly (indivisible shapes, unsupported signature) — the
        backend then falls back to the single-device stacked forward.  The base class knows nothing about
        any model's internal parallel structure, so it always declines.
        """
        return None

    @staticmethod
    def _literals_equal(a: Any, b: Any) -> bool:
        if a is b:
            return True
        try:
            return bool(a == b)
        except Exception:
            return False

    def _stack_inputs(
        self, batch_kwargs: List[Dict[str, Any]]
    ) -> Tuple[Optional[Dict[str, Any]], Optional[List[int]]]:
        """Concatenate TensorType inputs along axis 0; None when unsound."""
        from repro_torch.core.types import TensorType

        names = set(batch_kwargs[0])
        if any(set(kw) != names for kw in batch_kwargs[1:]):
            return None, None
        stacked: Dict[str, Any] = {}
        sizes: Optional[List[int]] = None
        for name in names:
            vals = [kw[name] for kw in batch_kwargs]
            port = self._inputs.get(name)
            tensor_port = port is not None and isinstance(port.type, TensorType)
            if tensor_port and all(hasattr(v, "shape") and getattr(v, "ndim", 0) > 0
                                   for v in vals):
                if any(v.shape[1:] != vals[0].shape[1:] for v in vals[1:]):
                    return None, None
                these = [int(v.shape[0]) for v in vals]
                if sizes is None:
                    sizes = these
                elif these != sizes:
                    return None, None
                import torch

                stacked[name] = torch.cat(vals, dim=0)
            else:
                if any(not self._literals_equal(v, vals[0]) for v in vals[1:]):
                    return None, None
                stacked[name] = vals[0]
        if sizes is None:      # nothing tensor-valued to stack
            return None, None
        return stacked, sizes

    def _split_outputs(
        self, out: Dict[str, Any], sizes: List[int]
    ) -> List[Dict[str, Any]]:
        """Split axis-0-stacked TensorType outputs back per request."""
        from repro_torch.core.types import TensorType

        total = sum(sizes)
        results: List[Dict[str, Any]] = [dict() for _ in sizes]
        for name, val in out.items():
            port = self._outputs.get(name)
            splittable = (
                port is not None
                and isinstance(port.type, TensorType)
                and hasattr(val, "shape")
                and getattr(val, "ndim", 0) > 0
                and int(val.shape[0]) == total
            )
            if splittable:
                off = 0
                for i, n in enumerate(sizes):
                    results[i][name] = val[off:off + n]
                    off += n
            else:
                for r in results:
                    r[name] = val
        return results

    def fold_patches(
        self,
        components: Dict[str, Any],
        patches: List["Model"],
        patch_components: List[Dict[str, Any]],
    ) -> Dict[str, Any]:
        """Return ``components`` with weight patches (LoRA-class) folded in.

        Called by the executor backend ONCE per ``(model_id, patch_ids)``
        placement — the folded result is cached, so per-step execution never
        re-folds.  The default ignores patches (models without patchable
        weights).  Must be purely functional: the input pytree stays intact.
        """
        return components

    # ------------------------------------------------------------ costing
    def cost(self) -> ModelCost:
        """Analytic cost description (overridden by real models)."""
        return ModelCost(
            flops_per_item=1e9,
            param_bytes=1e8,
            act_io_bytes=1e7,
            output_bytes=1e6,
        )

    # Is this a lightweight operator (scheduler may run it inline on the
    # coordinator instead of dispatching to an executor)?
    trivial: bool = False

    # ------------------------------------------------- segment execution
    # Role this model plays in a fusable per-step denoise chain
    # (``SegmentFusionPass`` pattern-matches on these):
    #   "backbone"   — the diffusion backbone (must offer build_segment());
    #   "denoise"    — the scheduler (Euler) step;
    #   "controlnet" — an add-on residual branch;
    #   "combine"    — the residual fan-in sum.
    # None (the default) means the model never participates in fusion.
    scan_role: Optional[str] = None

    # True for fused multi-step segment models (e.g. ``DenoiseSegment``).
    # A segment's node carries its step schedule in the node inputs
    # (``t_mid``/``t_cur``/``t_next`` tuples); the runtime may execute it
    # in load-adaptive chunks by passing the reserved kwargs
    # ``_seg_start`` (first step index, per item) and ``_seg_steps``
    # (chunk length, uniform across a batch) to ``execute``/
    # ``execute_batch``/``execute_batch_sharded``.  One full call covers
    # ``cost().steps_per_call`` steps.
    is_segment: bool = False

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} id={self.model_id}>"
