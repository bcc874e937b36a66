"""LegoDiffusion core: micro-serving of diffusion workflows, PyTorch port.

Public surface (the single-device, sharded and process-isolated
executable planes):

* DSL      -- Model, Workflow, compose
* Compiler -- GraphCompiler, optimization passes
* Runtime  -- Coordinator, ServingSystem, LocalBackend, ShardedBackend,
  MeshManager, ProcBackend
* Policy   -- Scheduler, AdmissionController, Autoscaler
"""

from repro_torch.core.admission import AdmissionController, critical_path_seconds
from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig, ScaleAction
from repro_torch.core.compiler import CompiledGraph, CompileError, GraphCompiler, Pass
from repro_torch.core.datastore import DataEngine, FetchFuture
from repro_torch.core.executor import Executor, LocalBackend, OutOfMemory, ShardedBackend
from repro_torch.core.faults import (
    DataFetchError,
    FaultPlane,
    InjectedFault,
    RetryPolicy,
    TransientBackendError,
)
from repro_torch.core.mesh import MeshManager, sharded_exec_enabled
from repro_torch.core.model import Model, ModelCost
from repro_torch.core.passes import (
    ApproximateCachingPass,
    AsyncLoRAPass,
    DeadCodeEliminationPass,
    InlineTrivialPass,
    JitCompilePass,
    SegmentFusionPass,
    default_passes,
    segment_fusion_enabled,
)
from repro_torch.core.profiles import GPU_H800, TPU_V5E, HardwareSpec, LatencyProfile, ProfileStore
from repro_torch.core.registry import ServingSystem, WorkflowRegistry
from repro_torch.core.runtime import Coordinator, Request, RequestNode
from repro_torch.core.scheduler import ScheduledBatch, Scheduler
from repro_torch.core.supervisor import ProcBackend, ProcConfig, Supervisor, processes_available
from repro_torch.core.telemetry import (
    FoldCacheEviction,
    MetricsRegistry,
    TelemetryEvent,
    configure as configure_telemetry,
    default_registry,
    telemetry_enabled,
    validate_chrome_trace,
)
from repro_torch.core.tracing import COORDINATOR_PID, NULL_TRACER, NullTracer, Tracer, make_tracer
from repro_torch.core.transport import (
    ChecksumError,
    FrameChannel,
    StagedInput,
    TransportError,
    WorkerDied,
)
from repro_torch.core.types import (
    DataRef,
    Image,
    Port,
    TensorType,
    ValueRef,
    WorkflowTypeError,
)
from repro_torch.core.workflow import Workflow, WorkflowContext, WorkflowNode, WorkflowTemplate, compose
from repro_torch.core.group import CoordinatorGroup, cluster_workflows
