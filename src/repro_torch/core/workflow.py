"""Workflow composition and tracing (§4.1, Fig. 7).

Workflow developers compose *declaratively*: they declare inputs/outputs,
instantiate models, and call them inside a ``Workflow`` scope.  Every model
invocation is recorded as a :class:`WorkflowNode`; nobody wires a DAG by
hand.  The graph compiler (:mod:`repro_torch.core.compiler`) later resolves the
recorded invocations into a topologically-sorted DAG.

Static inputs (``static=True``) are python values consumed by control flow
during composition (e.g. ``num_denoising_steps`` driving the denoising
loop).  Workflows are compiled once at registration with default statics and
lazily *re-instantiated* per request when a request overrides them —
the paper's lazy execution / dynamic graph recomposition (§4.3.1).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.model import Model
from repro_torch.core.types import Port, PortType, ValueRef, WorkflowTypeError, check_value

_node_ids = itertools.count()


class WorkflowNode:
    """One recorded model invocation — the fundamental micro-serving unit."""

    def __init__(self, op: Model, inputs: Dict[str, Any]) -> None:
        self.id: int = next(_node_ids)
        self.op = op
        self.inputs = dict(inputs)          # name -> ValueRef | literal
        self.attrs: Dict[str, Any] = {}     # pass-added attributes
        self._output_refs: Dict[str, ValueRef] = {
            name: ValueRef(name=f"{op.model_id}.{name}#{self.id}",
                           type=port.type, producer=self.id, port=name)
            for name, port in op.outputs.items()
        }

    # Names of inputs that are deferred per the model's I/O declaration.
    def deferred_input_names(self) -> List[str]:
        return [n for n, p in self.op.inputs.items() if p.deferred and n in self.inputs]

    def eager_input_refs(self) -> List[ValueRef]:
        out = []
        for name, v in self.inputs.items():
            port = self.op.inputs.get(name)
            if isinstance(v, ValueRef) and port is not None and not port.deferred:
                out.append(v)
        return out

    def deferred_input_refs(self) -> List[ValueRef]:
        out = []
        for name, v in self.inputs.items():
            port = self.op.inputs.get(name)
            if isinstance(v, ValueRef) and port is not None and port.deferred:
                out.append(v)
        return out

    def all_input_refs(self) -> List[ValueRef]:
        return [v for v in self.inputs.values() if isinstance(v, ValueRef)]

    def get_outputs(self) -> Any:
        if len(self._output_refs) == 1:
            return next(iter(self._output_refs.values()))
        return dict(self._output_refs)

    @property
    def output_refs(self) -> Dict[str, ValueRef]:
        return self._output_refs

    def clone(self) -> "WorkflowNode":
        """A same-id copy with private ``inputs``/``attrs`` dicts.

        The graph compiler clones every node before running passes, so
        rewrites (input rewiring, fusion, attr annotations) never leak
        into the template's cached trace — one ``Workflow`` may compile
        under several pass pipelines (e.g. per-coordinator compilers in a
        :class:`~repro_torch.core.group.CoordinatorGroup`)."""
        n = object.__new__(WorkflowNode)
        n.id = self.id
        n.op = self.op
        n.inputs = dict(self.inputs)
        n.attrs = dict(self.attrs)
        n._output_refs = self._output_refs
        return n

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<Node {self.id}:{self.op.model_id}>"


class WorkflowContext:
    """Thread-local stack of workflows under composition."""

    _local = threading.local()

    @classmethod
    def _stack(cls) -> List["Workflow"]:
        if not hasattr(cls._local, "stack"):
            cls._local.stack = []
        return cls._local.stack

    @classmethod
    def push(cls, wf: "Workflow") -> None:
        cls._stack().append(wf)

    @classmethod
    def pop(cls) -> "Workflow":
        return cls._stack().pop()

    @classmethod
    def get_current_workflow(cls) -> Optional["Workflow"]:
        stack = cls._stack()
        return stack[-1] if stack else None


class Workflow:
    """A traced diffusion workflow (Fig. 7).

    Usable as a context manager::

        with Workflow(name="flux_txt2img") as wf:
            prompt = wf.add_input("prompt", str)
            ...
            wf.add_output(img, name="output_img")

    or by explicit ``activate()`` / ``finalize()`` calls.
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self.nodes: List[WorkflowNode] = []
        self.inputs: Dict[str, Port] = {}
        self.static_inputs: Dict[str, Any] = {}   # name -> default value
        self.outputs: Dict[str, ValueRef] = {}
        self._bindings: Dict[str, Any] = {}       # static overrides while tracing
        self._active = False
        self._node_index: Dict[int, WorkflowNode] = {}   # id -> node

    # -------------------------------------------------------------- scope
    def __enter__(self) -> "Workflow":
        self.activate()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        self.finalize()

    def activate(self) -> None:
        self._active = True
        WorkflowContext.push(self)

    def finalize(self) -> None:
        self._active = False
        top = WorkflowContext.pop()
        assert top is self, "unbalanced workflow scopes"

    # ------------------------------------------------------------ inputs
    def add_input(
        self,
        name: str,
        data_type: PortType = None,
        static: bool = False,
        default: Any = None,
    ) -> Any:
        """Declare a workflow input placeholder.

        Static inputs return a *concrete* python value (the per-request
        binding or the registration default) so they can drive composition
        control flow; dynamic inputs return a symbolic :class:`ValueRef`.
        """
        self.inputs[name] = Port(name, data_type)
        if static:
            value = self._bindings.get(name, default)
            if value is None:
                raise WorkflowTypeError(
                    f"workflow '{self.name}': static input '{name}' needs a "
                    "default or a per-request binding"
                )
            if data_type is not None and not check_value(data_type, value):
                raise WorkflowTypeError(
                    f"workflow '{self.name}': static input '{name}'={value!r} "
                    f"violates declared type"
                )
            self.static_inputs[name] = value
            return value
        return ValueRef(name=name, type=data_type, is_input=True)

    def add_output(self, value: ValueRef, name: str) -> None:
        if not isinstance(value, ValueRef):
            raise WorkflowTypeError(
                f"workflow '{self.name}': output '{name}' must be a traced "
                f"value, got {type(value).__name__}"
            )
        self.outputs[name] = value

    # ------------------------------------------------------------- nodes
    def add_workflow_node(self, node: WorkflowNode) -> None:
        if not self._active:
            raise RuntimeError("workflow is not active")
        self.nodes.append(node)
        self._node_index[node.id] = node

    def node_by_id(self, node_id: int) -> WorkflowNode:
        try:
            return self._node_index[node_id]
        except KeyError:
            raise KeyError(node_id) from None

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<Workflow {self.name}: {len(self.nodes)} nodes>"


def freeze_bindings(static_bindings: Dict[str, Any]) -> Optional[tuple]:
    """A hashable cache key for a static-binding dict, or None when any
    value is unhashable (list/dict statics) — callers then skip caching
    and re-trace, instead of crashing on the dict lookup."""
    key = tuple(sorted(static_bindings.items(), key=lambda kv: kv[0]))
    try:
        hash(key)
    except TypeError:
        return None
    return key


class WorkflowTemplate:
    """A registered, re-traceable workflow.

    ``compose_fn(**static_bindings) -> Workflow`` re-runs the developer's
    composition code.  Per-request graphs are cached keyed on the static
    bindings — this realizes lazy execution with dynamic graph recomposition
    (§4.3.1) without re-tracing identical requests.  Unhashable binding
    values (e.g. a list-valued static) fall back to an uncached re-trace,
    counted in ``uncached_traces``.
    """

    def __init__(self, name: str, compose_fn: Callable[..., Workflow]) -> None:
        self.name = name
        self.compose_fn = compose_fn
        self._cache: Dict[Any, Workflow] = {}
        self.uncached_traces = 0

    def instantiate(self, **static_bindings: Any) -> Workflow:
        key = freeze_bindings(static_bindings)
        if key is None:
            self.uncached_traces += 1
        elif key in self._cache:
            return self._cache[key]
        wf = self.compose_fn(**static_bindings)
        if not isinstance(wf, Workflow):
            raise TypeError(
                f"compose function for '{self.name}' must return a Workflow"
            )
        if key is not None:
            self._cache[key] = wf
        return wf


def compose(name: str) -> Callable[[Callable[..., None]], WorkflowTemplate]:
    """Decorator turning a composition function into a WorkflowTemplate.

    The decorated function receives an active ``Workflow`` as its first
    argument plus any static bindings::

        @compose("flux_txt2img")
        def flux_wf(wf, num_denoising_steps=30):
            prompt = wf.add_input("prompt", str)
            ...
    """

    def deco(fn: Callable[..., None]) -> WorkflowTemplate:
        def compose_fn(**static_bindings: Any) -> Workflow:
            wf = Workflow(name=name)
            wf._bindings = dict(static_bindings)
            with wf:
                fn(wf, **static_bindings)
            return wf

        return WorkflowTemplate(name, compose_fn)

    return deco
