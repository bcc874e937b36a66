"""Graph compiler (§4.2): lowers a traced ``Workflow`` into a
topologically-sorted DAG of schedulable nodes and runs optimization passes.

The compiler is deliberately small: DAG construction + validation + a pass
manager.  All diffusion-specific smarts live in :mod:`repro_torch.core.passes`,
matching the paper's "adding a new optimization requires only a new pass"
extensibility claim.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.core.types import ValueRef, WorkflowTypeError
from repro_torch.core.workflow import Workflow, WorkflowNode


class CompileError(Exception):
    pass


class CompiledGraph:
    """A validated, topologically sorted workflow DAG."""

    def __init__(self, workflow: Workflow, nodes: List[WorkflowNode]) -> None:
        self.workflow = workflow
        self.name = workflow.name
        self.nodes: List[WorkflowNode] = nodes
        self.outputs: Dict[str, ValueRef] = dict(workflow.outputs)
        self.input_ports = dict(workflow.inputs)
        # derived structures, rebuilt after every pass
        self.producers: Dict[int, WorkflowNode] = {}
        self.consumers: Dict[int, List[WorkflowNode]] = {}
        self.depth: Dict[int, int] = {}
        self.rebuild()

    # ------------------------------------------------------------ analysis
    def rebuild(self) -> None:
        self.producers = {n.id: n for n in self.nodes}
        consumers: Dict[int, List[WorkflowNode]] = defaultdict(list)
        for n in self.nodes:
            for ref in n.all_input_refs():
                if ref.producer is not None:
                    consumers[ref.producer].append(n)
        self.consumers = dict(consumers)
        self._toposort()
        self._compute_depth()

    def _toposort(self) -> None:
        indeg: Dict[int, int] = {n.id: 0 for n in self.nodes}
        for n in self.nodes:
            for ref in n.all_input_refs():
                if ref.producer is not None:
                    if ref.producer not in indeg:
                        raise CompileError(
                            f"node {n} consumes {ref} produced outside the graph"
                        )
                    indeg[n.id] += 1
        queue = deque([n for n in self.nodes if indeg[n.id] == 0])
        order: List[WorkflowNode] = []
        by_id = {n.id: n for n in self.nodes}
        while queue:
            n = queue.popleft()
            order.append(n)
            for c in self.consumers.get(n.id, []):
                indeg[c.id] -= 1
                if indeg[c.id] == 0:
                    queue.append(by_id[c.id])
        if len(order) != len(self.nodes):
            raise CompileError(
                f"workflow '{self.name}' has a cycle "
                f"({len(order)}/{len(self.nodes)} nodes ordered)"
            )
        self.nodes = order

    def _compute_depth(self) -> None:
        depth: Dict[int, int] = {}
        for n in self.nodes:  # topo order
            d = 0
            for ref in n.all_input_refs():
                if ref.producer is not None:
                    d = max(d, depth[ref.producer] + 1)
            depth[n.id] = d
        self.depth = depth

    # ------------------------------------------------------------- editing
    def replace_node(self, old: WorkflowNode, new: WorkflowNode) -> None:
        """Substitute ``new`` for ``old``, rewiring consumers port-by-port."""
        mapping = {}
        for port, ref in old.output_refs.items():
            if port not in new.output_refs:
                raise CompileError(
                    f"replacement {new} lacks output port '{port}' of {old}"
                )
            mapping[(old.id, port)] = new.output_refs[port]
        idx = self.nodes.index(old)
        self.nodes[idx] = new
        self._rewire(mapping)
        self.rebuild()

    def remove_nodes(self, dead: Iterable[WorkflowNode]) -> None:
        dead_ids = {n.id for n in dead}
        self.nodes = [n for n in self.nodes if n.id not in dead_ids]
        self.rebuild()

    def insert_node(self, node: WorkflowNode) -> None:
        self.nodes.append(node)
        self.rebuild()

    def fuse_nodes(
        self,
        fused: Iterable[WorkflowNode],
        replacement: WorkflowNode,
        output_map: Dict[ValueRef, ValueRef],
    ) -> None:
        """Replace a connected region of nodes with one node.

        ``output_map`` maps every ref produced INSIDE the region that is
        still consumed outside it (or named as a workflow output) to the
        corresponding output ref of ``replacement``.  Refs produced in the
        region but absent from the map must be fully internal — consumed
        only by other fused nodes; anything else fails validation after
        the rewrite, which is the safety net pass authors rely on.
        """
        fused_ids = {n.id for n in fused}
        self.nodes = [n for n in self.nodes if n.id not in fused_ids]
        self.nodes.append(replacement)
        for n in self.nodes:
            for name, v in list(n.inputs.items()):
                if isinstance(v, ValueRef) and v in output_map:
                    n.inputs[name] = output_map[v]
        for out_name, ref in list(self.outputs.items()):
            if ref in output_map:
                self.outputs[out_name] = output_map[ref]
        self.rebuild()

    def _rewire(self, mapping: Dict[Any, ValueRef]) -> None:
        for n in self.nodes:
            for name, v in list(n.inputs.items()):
                if isinstance(v, ValueRef) and v.producer is not None:
                    repl = mapping.get((v.producer, v.port))
                    if repl is not None:
                        n.inputs[name] = repl
        for out_name, ref in list(self.outputs.items()):
            repl = mapping.get((ref.producer, ref.port))
            if repl is not None:
                self.outputs[out_name] = repl

    def rewire_input(self, node: WorkflowNode, input_name: str, ref: ValueRef) -> None:
        node.inputs[input_name] = ref
        self.rebuild()

    # ----------------------------------------------------------- validation
    def validate(self) -> None:
        known_inputs = set(self.input_ports)
        produced = {n.id for n in self.nodes}
        for n in self.nodes:
            for name, v in n.inputs.items():
                if isinstance(v, ValueRef):
                    if v.is_input:
                        if v.name not in known_inputs:
                            raise CompileError(
                                f"{n} consumes undeclared workflow input '{v.name}'"
                            )
                    elif v.producer not in produced:
                        raise CompileError(f"{n} consumes dangling ref {v}")
        for name, ref in self.outputs.items():
            if not ref.is_input and ref.producer not in produced:
                raise CompileError(f"workflow output '{name}' is dangling")
        if not self.outputs:
            raise CompileError(f"workflow '{self.name}' declares no outputs")

    # ------------------------------------------------------------- queries
    def nodes_of_model(self, model_id: str) -> List[WorkflowNode]:
        return [n for n in self.nodes if n.op.model_id == model_id]

    def model_ids(self) -> List[str]:
        seen: List[str] = []
        for n in self.nodes:
            if n.op.model_id not in seen:
                seen.append(n.op.model_id)
        return seen

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<CompiledGraph {self.name}: {len(self.nodes)} nodes>"


class Pass:
    """Base class for graph-rewriting optimization passes."""

    name = "pass"

    def run(self, graph: CompiledGraph) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class GraphCompiler:
    """Front door: ``compile(workflow)`` → validated :class:`CompiledGraph`."""

    def __init__(self, passes: Optional[Sequence[Pass]] = None) -> None:
        self.passes: List[Pass] = list(passes or [])

    def add_pass(self, p: Pass) -> None:
        self.passes.append(p)

    def compile(self, workflow: Workflow) -> CompiledGraph:
        # clone nodes so passes rewrite THIS graph, not the template's
        # cached trace (one workflow may compile under several pipelines)
        graph = CompiledGraph(workflow, [n.clone() for n in workflow.nodes])
        graph.validate()
        for p in self.passes:
            p.run(graph)
            graph.validate()
        return graph
