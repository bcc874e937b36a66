"""Diffusion-specific graph optimization passes (§4.2).

Each pass pattern-matches on node properties and may insert, remove or
replace nodes.  Shipped passes:

* :class:`InlineTrivialPass`      — run tiny elementwise ops (e.g. the
  ``denoise`` scheduler step) inline on the coordinator;
* :class:`JitCompilePass`         — per-node compilation marks (the paper's
  ``torch.compile()`` analogue);
* :class:`ApproximateCachingPass` — Nirvana-style approximate caching [4]:
  replace random-latent init with a cache lookup and skip the first K
  denoising iterations;
* :class:`AsyncLoRAPass`          — Katz-style asynchronous LoRA loading
  [38]: insert an I/O-only fetch node and per-step readiness checks;
* :class:`SegmentFusionPass`      — fuse runs of consecutive denoising
  steps (ControlNet → ResidualCombine → backbone → scheduler step) into
  single ``DenoiseSegment`` nodes executed as one jitted scan, with the
  chunk granularity chosen by the scheduler at dispatch time;
* :class:`DeadCodeEliminationPass`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.compiler import CompiledGraph, CompileError, Pass
from repro_torch.core.model import Model, ModelCost
from repro_torch.core.types import TensorType, ValueRef
from repro_torch.core.workflow import WorkflowNode


# --------------------------------------------------------------------------
# Synthetic ops inserted by passes
# --------------------------------------------------------------------------

class CacheLookup(Model):
    """Approximate-cache lookup: returns a pre-denoised latent [Nirvana]."""

    def __init__(self, cache: Any, skip_steps: int, **kw: Any) -> None:
        self.cache = cache
        self.skip_steps = skip_steps
        super().__init__(model_id="approx_cache_lookup", **kw)

    def setup_io(self) -> None:
        self.add_input("prompt", str)
        self.add_output("latents", TensorType())

    def execute(self, model_components: Dict[str, Any], **kwargs: Any) -> Dict[str, Any]:
        latents = self.cache.lookup(kwargs["prompt"], self.skip_steps)
        if latents is None:
            raise CompileError("approximate-cache miss at execution time")
        return {"latents": latents}

    def cost(self) -> ModelCost:
        return ModelCost(flops_per_item=0, param_bytes=0,
                         act_io_bytes=1e6, output_bytes=1e6, max_batch=64)

    trivial = True


class LoRAFetch(Model):
    """Asynchronous adapter fetch from remote storage — pure I/O node."""

    def __init__(self, patch: Model, **kw: Any) -> None:
        self.patch = patch
        super().__init__(model_id=f"lora_fetch:{patch.model_id}", **kw)

    def setup_io(self) -> None:
        self.add_output("adapter_weights", TensorType())

    def execute(self, model_components: Dict[str, Any], **kwargs: Any) -> Dict[str, Any]:
        return {"adapter_weights": self.patch.load(device=None)}

    def cost(self) -> ModelCost:
        pc = self.patch.cost()
        return ModelCost(flops_per_item=0, param_bytes=0,
                         act_io_bytes=pc.param_bytes,
                         output_bytes=pc.param_bytes, max_batch=1)


# --------------------------------------------------------------------------
# Passes
# --------------------------------------------------------------------------

class InlineTrivialPass(Pass):
    name = "inline-trivial"

    def run(self, graph: CompiledGraph) -> None:
        for n in graph.nodes:
            if getattr(n.op, "trivial", False):
                n.attrs["inline"] = True


class JitCompilePass(Pass):
    """Mark executor-run nodes for per-node jit compilation."""

    name = "jit-compile"

    def run(self, graph: CompiledGraph) -> None:
        for n in graph.nodes:
            if not n.attrs.get("inline"):
                n.attrs["jit"] = True


def dead_code_eliminate(graph: CompiledGraph) -> List[WorkflowNode]:
    """Remove nodes not reachable from workflow outputs (keep side-effects)."""
    live: Set[int] = set()
    stack = [ref.producer for ref in graph.outputs.values()
             if ref.producer is not None]
    keep_alive = [n for n in graph.nodes if n.attrs.get("keep_alive")]
    stack.extend(n.id for n in keep_alive)
    by_id = {n.id: n for n in graph.nodes}
    while stack:
        nid = stack.pop()
        if nid in live:
            continue
        live.add(nid)
        for ref in by_id[nid].all_input_refs():
            if ref.producer is not None and ref.producer not in live:
                stack.append(ref.producer)
    dead = [n for n in graph.nodes if n.id not in live]
    if dead:
        graph.remove_nodes(dead)
    return dead


class DeadCodeEliminationPass(Pass):
    name = "dce"

    def run(self, graph: CompiledGraph) -> None:
        dead_code_eliminate(graph)


class ApproximateCachingPass(Pass):
    """Nirvana-style approximate caching [4].

    When the cache reports a hit for the request's prompt, replace the
    latent produced by denoising iteration ``K-1`` with a cache lookup and
    let DCE drop iterations ``0..K-1`` (backbone, ControlNet and scheduler
    steps alike).  ``K = round(skip_fraction * num_backbone_steps)``.

    The workflow developer changes nothing — the rewrite keys purely on the
    graph structure (the chain of backbone invocations), exactly as in §4.2.
    """

    name = "approximate-caching"

    def __init__(
        self,
        cache: Any,
        backbone_model_id: str,
        latent_input_name: str = "latents",
        skip_fraction: float = 0.0,
        prompt_input_name: str = "prompt",
    ) -> None:
        self.cache = cache
        self.backbone_model_id = backbone_model_id
        self.latent_input_name = latent_input_name
        self.skip_fraction = skip_fraction
        self.prompt_input_name = prompt_input_name

    def run(self, graph: CompiledGraph) -> None:
        if self.skip_fraction <= 0 or self.cache is None:
            return
        backbone = graph.nodes_of_model(self.backbone_model_id)
        if not backbone:
            return
        k = int(round(self.skip_fraction * len(backbone)))
        if k <= 0:
            return
        if k >= len(backbone):
            k = len(backbone) - 1
        target = backbone[k]
        if self.latent_input_name not in target.inputs:
            raise CompileError(
                f"backbone node {target} has no input "
                f"'{self.latent_input_name}' to rewire"
            )
        lookup_op = CacheLookup(self.cache, skip_steps=k)
        prompt_ref = ValueRef(name=self.prompt_input_name, type=str, is_input=True)
        lookup_node = WorkflowNode(op=lookup_op, inputs={"prompt": prompt_ref})
        lookup_node.attrs["inline"] = True
        graph.insert_node(lookup_node)
        # rewire EVERY consumer of the pre-skip latent (the scheduler-step
        # chain consumes it too, not just the backbone)
        old_ref = target.inputs[self.latent_input_name]
        new_ref = lookup_node.output_refs["latents"]
        for n in graph.nodes:
            if n is lookup_node:
                continue
            for iname, v in list(n.inputs.items()):
                if isinstance(v, ValueRef) and v == old_ref:
                    n.inputs[iname] = new_ref
        graph.rebuild()
        removed = dead_code_eliminate(graph)
        graph.workflow.static_inputs["_approx_cache_skipped"] = len(
            [n for n in removed if n.op.model_id == self.backbone_model_id]
        )


def segment_fusion_enabled() -> bool:
    """Global gate for segment fusion (``REPRO_SEGMENT_FUSION``)."""
    return os.environ.get("REPRO_SEGMENT_FUSION", "1").lower() not in (
        "0", "false", "off")


@dataclasses.dataclass
class _StepUnit:
    """One matched denoising step: CN tree → backbone → scheduler step."""

    backbone: WorkflowNode
    denoise: WorkflowNode
    cn_nodes: List[WorkflowNode]        # leaves, left-to-right
    tree_nodes: List[WorkflowNode]      # cn leaves + combine interior nodes
    lat_ref: ValueRef                   # latents consumed by this step
    emb_ref: ValueRef
    cond_ref: Any                       # shared ControlNet conditioning (or None)
    t_mid: float                        # backbone/CN timestep
    t_cur: float                        # Euler step interval
    t_next: float
    guidance: Any

    def member_ids(self) -> Set[int]:
        return ({self.backbone.id, self.denoise.id}
                | {n.id for n in self.tree_nodes})

    def signature(self) -> Tuple:
        """What must agree for two units to fuse into one scan."""
        return (id(self.backbone.op),
                tuple(id(n.op) for n in self.cn_nodes),
                self.emb_ref, self.cond_ref, self.guidance)


class SegmentFusionPass(Pass):
    """Fuse runs of consecutive denoising steps into ``DenoiseSegment``
    nodes (§4.2 rewrite + §5.2 granularity-as-a-scheduling-decision).

    Pattern per step: ``ControlNet* → ResidualCombine* →
    DiffusionBackbone → DenoiseStep`` — recognized structurally via the
    ops' ``scan_role`` declarations, never by concrete class, so the pass
    stays diffusion-agnostic.  Runs of ≥ ``min_steps`` steps chained
    through their latent carry collapse into ONE node whose executable is
    a single multi-step forward (see ``DenoiseSegment``); the
    scheduler later picks the chunk size each dispatch actually runs.

    Composes with the other shipped passes:

    * ``ApproximateCachingPass`` (run before): a cache hit shortens the
      chain — the segment simply starts at the cache lookup's latent;
    * ``AsyncLoRAPass`` (either order): the segment op forwards the
      backbone's patches, and any ``lora_check``/``patch_ids``
      annotations already on the backbone nodes carry over.
    """

    name = "segment-fusion"

    def __init__(self, min_steps: int = 2) -> None:
        self.min_steps = max(2, int(min_steps))

    # ---------------------------------------------------------- structure
    @staticmethod
    def _role(node: WorkflowNode) -> Optional[str]:
        return getattr(node.op, "scan_role", None)

    @staticmethod
    def _literal(node: WorkflowNode, name: str) -> Tuple[bool, Any]:
        """(present-and-literal?, value) for an input."""
        if name not in node.inputs:
            return False, None
        v = node.inputs[name]
        if isinstance(v, ValueRef):
            return False, None
        return True, v

    def _match_res_tree(
        self,
        graph: CompiledGraph,
        ref: ValueRef,
        unit_lat: ValueRef,
        emb_ref: ValueRef,
        t_mid: Any,
        ref_consumers: Dict[ValueRef, Set[int]],
        out_refs: Set[ValueRef],
        expect_consumer: int,
    ) -> Optional[Tuple[List[WorkflowNode], List[WorkflowNode], Any]]:
        """Match the ControlNet fan-in feeding a backbone: returns
        (cn leaves left-to-right, all tree nodes, shared cond ref)."""
        if ref.producer is None or ref in out_refs:
            return None
        if ref_consumers.get(ref, set()) != {expect_consumer}:
            return None      # residuals tapped elsewhere: not fusable
        node = graph.producers.get(ref.producer)
        if node is None:
            return None
        role = self._role(node)
        if role == "controlnet":
            if node.inputs.get("latents") != unit_lat:
                return None
            if node.inputs.get("prompt_embeds") != emb_ref:
                return None
            ok, t = self._literal(node, "t")
            if not ok or float(t) != float(t_mid):
                return None
            return [node], [node], node.inputs.get("cond_latents")
        if role == "combine":
            a, b = node.inputs.get("a"), node.inputs.get("b")
            if not (isinstance(a, ValueRef) and isinstance(b, ValueRef)):
                return None
            left = self._match_res_tree(graph, a, unit_lat, emb_ref, t_mid,
                                        ref_consumers, out_refs, node.id)
            right = self._match_res_tree(graph, b, unit_lat, emb_ref, t_mid,
                                         ref_consumers, out_refs, node.id)
            if left is None or right is None or left[2] != right[2]:
                return None
            return (left[0] + right[0],
                    left[1] + right[1] + [node], left[2])
        return None

    def _match_unit(
        self,
        graph: CompiledGraph,
        denoise: WorkflowNode,
        ref_consumers: Dict[ValueRef, Set[int]],
        out_refs: Set[ValueRef],
    ) -> Optional[_StepUnit]:
        v_ref = denoise.inputs.get("velocity")
        if not isinstance(v_ref, ValueRef) or v_ref.producer is None:
            return None
        backbone = graph.producers.get(v_ref.producer)
        if backbone is None or self._role(backbone) != "backbone":
            return None
        if not hasattr(backbone.op, "build_segment"):
            return None
        if v_ref in out_refs or ref_consumers.get(v_ref, set()) != {denoise.id}:
            return None
        lat_ref = denoise.inputs.get("latents")
        if not isinstance(lat_ref, ValueRef):
            return None
        if backbone.inputs.get("latents") != lat_ref:
            return None
        emb_ref = backbone.inputs.get("prompt_embeds")
        if not isinstance(emb_ref, ValueRef):
            return None
        ok_t, t_mid = self._literal(backbone, "t")
        ok_c, t_cur = self._literal(denoise, "t_cur")
        ok_n, t_next = self._literal(denoise, "t_next")
        if not (ok_t and ok_c and ok_n):
            return None
        if "guidance" in backbone.inputs:
            ok_g, guidance = self._literal(backbone, "guidance")
            if not ok_g:
                return None
        else:
            guidance = None
        cn_nodes: List[WorkflowNode] = []
        tree_nodes: List[WorkflowNode] = []
        cond_ref: Any = None
        res = backbone.inputs.get("controlnet_residuals")
        if isinstance(res, ValueRef):
            tree = self._match_res_tree(graph, res, lat_ref, emb_ref, t_mid,
                                        ref_consumers, out_refs, backbone.id)
            if tree is None:
                return None
            cn_nodes, tree_nodes, cond_ref = tree
        elif res is not None:
            return None      # a concrete literal residual: leave unfused
        return _StepUnit(backbone, denoise, cn_nodes, tree_nodes, lat_ref,
                         emb_ref, cond_ref, float(t_mid), float(t_cur),
                         float(t_next), guidance)

    # ------------------------------------------------------------ chaining
    def _find_chain(self, graph: CompiledGraph) -> Optional[List[_StepUnit]]:
        ref_consumers: Dict[ValueRef, Set[int]] = {}
        for n in graph.nodes:
            for v in n.inputs.values():
                if isinstance(v, ValueRef):
                    ref_consumers.setdefault(v, set()).add(n.id)
        out_refs = set(graph.outputs.values())
        units: List[_StepUnit] = []
        for n in graph.nodes:
            if self._role(n) == "denoise":
                u = self._match_unit(graph, n, ref_consumers, out_refs)
                if u is not None:
                    units.append(u)
        by_lat: Dict[ValueRef, _StepUnit] = {}
        for u in units:
            if u.lat_ref in by_lat:      # branching latent: ambiguous, skip
                by_lat.pop(u.lat_ref)
            else:
                by_lat[u.lat_ref] = u
        produced = {u.denoise.output_refs["latents"] for u in units}
        best: Optional[List[_StepUnit]] = None
        for u in by_lat.values():
            if u.lat_ref in produced:
                continue                 # not a chain head
            chain = [u]
            while True:
                carry = chain[-1].denoise.output_refs["latents"]
                nxt = by_lat.get(carry)
                if (nxt is None
                        or nxt.signature() != chain[0].signature()
                        or carry in out_refs
                        or not ref_consumers.get(carry, set()) <= nxt.member_ids()):
                    break
                chain.append(nxt)
            if len(chain) >= self.min_steps and (
                    best is None or len(chain) > len(best)):
                best = chain
        return best

    # ------------------------------------------------------------- rewrite
    def _rewrite(self, graph: CompiledGraph, chain: List[_StepUnit]) -> None:
        head = chain[0]
        seg_op = head.backbone.op.build_segment(
            [n.op for n in head.cn_nodes], len(chain))
        inputs: Dict[str, Any] = {
            "latents": head.lat_ref,
            "prompt_embeds": head.emb_ref,
            "t_mid": tuple(u.t_mid for u in chain),
            "t_cur": tuple(u.t_cur for u in chain),
            "t_next": tuple(u.t_next for u in chain),
            "guidance": head.guidance,
        }
        if head.cn_nodes:
            inputs["cond_latents"] = head.cond_ref
        seg_node = WorkflowNode(op=seg_op, inputs=inputs)
        for attr in ("lora_check", "patch_ids"):     # AsyncLoRA ran first?
            if attr in head.backbone.attrs:
                seg_node.attrs[attr] = head.backbone.attrs[attr]
        fused: List[WorkflowNode] = []
        for u in chain:
            fused.extend([u.backbone, u.denoise] + u.tree_nodes)
        last_out = chain[-1].denoise.output_refs["latents"]
        graph.fuse_nodes(fused, seg_node,
                         {last_out: seg_node.output_refs["latents"]})

    def run(self, graph: CompiledGraph) -> None:
        if not segment_fusion_enabled():
            return
        while True:
            chain = self._find_chain(graph)
            if chain is None:
                return
            self._rewrite(graph, chain)


class AsyncLoRAPass(Pass):
    """Katz-style asynchronous LoRA loading [38].

    For every node whose model carries ``add_patch()`` attachments, insert
    one root-level :class:`LoRAFetch` node per patch (triggered at request
    admission, overlapping with early inference) and annotate each patched
    node with readiness-check metadata.  The runtime hot-patches the model
    functionally between denoising steps once the fetch future resolves —
    the TPU-idiomatic analogue of Katz's mid-stream weight patching.
    """

    name = "async-lora"

    def run(self, graph: CompiledGraph) -> None:
        fetch_for_patch: Dict[str, WorkflowNode] = {}
        patched_models = {}
        for n in list(graph.nodes):
            patches = n.op.patches
            if not patches:
                continue
            patched_models[n.op.model_id] = patches
            checks = []
            for patch in patches:
                key = patch.model_id
                if key not in fetch_for_patch:
                    fetch = WorkflowNode(op=LoRAFetch(patch), inputs={})
                    fetch.attrs["io_only"] = True
                    fetch.attrs["keep_alive"] = True
                    graph.insert_node(fetch)
                    fetch_for_patch[key] = fetch
                checks.append(fetch_for_patch[key].id)
            n.attrs["lora_check"] = checks
            n.attrs["patch_ids"] = [p.model_id for p in patches]


def default_passes() -> List[Pass]:
    # SegmentFusion runs before AsyncLoRA so the fused segment node (which
    # forwards the backbone's patches) is what receives the readiness
    # annotations; either order is correct — fusion carries existing
    # annotations over — but this one avoids annotating nodes about to fuse.
    return [InlineTrivialPass(), SegmentFusionPass(), AsyncLoRAPass(),
            JitCompilePass()]
