"""Workflow registration + the assembled serving system (Fig. 5).

``ServingSystem`` wires the frontend (workflow registration/invocation) to
the backend (compiler → scheduler → executors → data engine).  It is what
benchmarks and examples instantiate.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.admission import AdmissionController
from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.core.compiler import CompiledGraph, GraphCompiler, Pass
from repro_torch.core.executor import RESERVE, Executor, LocalBackend
from repro_torch.core.faults import FaultPlane, RetryPolicy
from repro_torch.core.passes import default_passes
from repro_torch.core.profiles import GPU_H800, HardwareSpec, ProfileStore
from repro_torch.core.runtime import Coordinator, Request
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.workflow import WorkflowTemplate, freeze_bindings


class WorkflowRegistry:
    def __init__(self, compiler: Optional[GraphCompiler] = None) -> None:
        self.compiler = compiler or GraphCompiler(default_passes())
        self._templates: Dict[str, WorkflowTemplate] = {}
        self._graph_cache: Dict[Any, CompiledGraph] = {}

    def register(self, template: WorkflowTemplate) -> None:
        self._templates[template.name] = template

    def names(self) -> List[str]:
        return sorted(self._templates)

    def instantiate(self, name: str, **static_bindings: Any) -> CompiledGraph:
        frozen = freeze_bindings(static_bindings)
        key = None if frozen is None else (name, frozen)
        if key is not None and key in self._graph_cache:
            return self._graph_cache[key]
        wf = self._templates[name].instantiate(**static_bindings)
        graph = self.compiler.compile(wf)
        if key is not None:      # unhashable statics: uncached re-compile
            self._graph_cache[key] = graph
        return graph


class ServingSystem:
    """Coordinator + registry + executor fleet, ready to take requests."""

    def __init__(
        self,
        n_executors: int = 8,
        hw: HardwareSpec = GPU_H800,
        scheduler: Optional[Scheduler] = None,
        admission_enabled: bool = False,
        extra_passes: Optional[Sequence[Pass]] = None,
        backend: Any = None,
        pods: int = 1,
        executor_memory: Optional[float] = None,
        autoscaler: Any = None,
        reserve_executors: int = 0,
        faults: Optional[FaultPlane] = None,
        retry_policy: Optional[RetryPolicy] = None,
        replicate_segments: bool = False,
        tracer: Any = None,
        metrics: Any = None,
        overlap: Optional[bool] = None,
    ) -> None:
        """``autoscaler`` enables per-model elastic scaling: pass ``True``
        for the default policy, an :class:`AutoscalerConfig`, or a built
        :class:`Autoscaler`.  ``reserve_executors`` adds that many cold
        standby devices the autoscaler may bring into service (they are
        never scheduled while in reserve).

        Chaos/hardening: ``faults`` attaches a deterministic
        :class:`~repro_torch.core.faults.FaultPlane` (defaults to whatever the
        ``REPRO_FAULTS`` environment variable specifies), ``retry_policy``
        overrides the timeout/backoff/quarantine knobs, and
        ``replicate_segments`` turns on replicate-on-commit for fused
        denoise-segment state.

        ``backend="proc"`` builds the process-isolated executor plane
        (each executor a separate OS process behind the frame transport,
        on the card; see :mod:`repro_torch.core.supervisor`) — remember to
        :meth:`close` the system, or use it as a context manager.

        Telemetry: ``tracer`` forces a specific span tracer (default:
        ``REPRO_TELEMETRY`` decides between a recording
        :class:`~repro_torch.core.tracing.Tracer` and the shared no-op);
        ``metrics`` overrides the process-wide default
        :class:`~repro_torch.core.telemetry.MetricsRegistry`."""
        if backend == "proc":
            from repro_torch.core.supervisor import ProcBackend

            backend = ProcBackend()
        self.profiles = ProfileStore(hw)
        passes = default_passes()
        if extra_passes:
            passes = list(extra_passes) + passes
        self.registry = WorkflowRegistry(GraphCompiler(passes))
        per_pod = max(1, n_executors // pods)
        executors = [
            Executor(i, self.profiles, memory_capacity=executor_memory, pod=i // per_pod)
            for i in range(n_executors)
        ]
        for j in range(reserve_executors):
            executors.append(Executor(
                n_executors + j, self.profiles, memory_capacity=executor_memory,
                pod=(n_executors + j) // per_pod, state=RESERVE,
            ))
        asc: Optional[Autoscaler] = None
        if autoscaler is True:
            asc = Autoscaler(self.profiles)
        elif isinstance(autoscaler, AutoscalerConfig):
            asc = Autoscaler(self.profiles, autoscaler)
        elif isinstance(autoscaler, Autoscaler):
            asc = autoscaler
        elif autoscaler not in (None, False):
            raise TypeError(f"autoscaler: {autoscaler!r}")
        self.coordinator = Coordinator(
            executors,
            self.profiles,
            # None -> the Coordinator builds the backend-aware default
            # (declared B_max + the sharded backend's mesh)
            scheduler=scheduler,
            admission=AdmissionController(self.profiles, enabled=admission_enabled),
            backend=backend,
            autoscaler=asc,
            faults=faults,
            retry_policy=retry_policy,
            replicate_segments=replicate_segments,
            tracer=tracer,
            metrics=metrics,
            # None -> the REPRO_OVERLAP environment default
            overlap=overlap,
        )

    # ---------------------------------------------------------------- API
    def register(self, template: WorkflowTemplate) -> None:
        self.registry.register(template)

    def submit(
        self,
        workflow: str,
        inputs: Optional[Dict[str, Any]] = None,
        arrival: Optional[float] = None,
        slo_seconds: Optional[float] = None,
        **static_bindings: Any,
    ) -> Request:
        graph = self.registry.instantiate(workflow, **static_bindings)
        return self.coordinator.submit(graph, inputs, arrival, slo_seconds)

    def run(self, until: Optional[float] = None) -> None:
        self.coordinator.run(until)

    def close(self) -> None:
        """Tear down backend resources (process-plane workers)."""
        backend = self.coordinator.backend
        if backend is not None and hasattr(backend, "close"):
            backend.close()

    def __enter__(self) -> "ServingSystem":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ------------------------------------------------------------ metrics
    @property
    def executors(self) -> List[Executor]:
        return self.coordinator.executors

    @property
    def autoscaler(self) -> Optional[Autoscaler]:
        return self.coordinator.autoscaler

    @property
    def tracer(self) -> Any:
        return self.coordinator.tracer

    @property
    def metrics(self) -> Any:
        return self.coordinator.metrics

    def export_trace(self, path: str, fmt: str = "chrome") -> None:
        """Write the recorded timeline (``chrome`` | ``jsonl``); raises
        if telemetry was disabled for this system."""
        self.coordinator.export_trace(path, fmt)

    def metrics_text(self) -> str:
        """Prometheus text-format dump of the metrics registry."""
        return self.coordinator.metrics_text()

    def slo_attainment(self, include_rejected: bool = True) -> float:
        return self.coordinator.slo_attainment(include_rejected)

    def mean_latency(self) -> float:
        return self.coordinator.mean_latency()

    def solo_latency(self, workflow: str, **static_bindings: Any) -> float:
        """Critical-path latency of one request on an idle cluster —
        the paper's 'solo inference latency' used to set SLO deadlines."""
        from repro_torch.core.admission import critical_path_seconds

        graph = self.registry.instantiate(workflow, **static_bindings)
        return critical_path_seconds(graph, self.profiles)
