"""Micro-serving control plane (§4.3.1) — the coordinator.

Runs the request-execution lifecycle over a discrete-event timeline:
requests arrive → admission control → root nodes enqueue → dispatch loop
(scheduler cycles) → executors report completions → downstream nodes become
ready → … → workflow outputs returned.

The same coordinator drives both planes:

* **simulation** — durations come from analytic latency profiles, values
  are byte counts (used for the paper's cluster-scale experiments);
* **executable** — a :class:`~repro_torch.core.executor.LocalBackend` really runs
  ``Model.load/execute`` on its torch device and measured durations feed
  the timeline (used by the examples and overhead benchmarks).

Fault tolerance follows the paper: intermediate data is immutable with
recorded lineage, so on executor failure the coordinator re-executes the
producing nodes of lost values and requeues whatever was running there.
The chaos plane (:mod:`repro_torch.core.faults`, gated by ``REPRO_FAULTS``)
makes those failure semantics testable: deterministic injected crashes,
hung/slow forwards, transient backend errors and datastore fetch losses,
answered by per-batch timeouts, capped-backoff retries with a bounded
budget (exhaustion sheds the request exactly once), flapping-executor
quarantine, and opt-in replication of committed segment state.
"""

from __future__ import annotations

import heapq
import itertools
import os
import time as _time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.admission import AdmissionController, critical_path_seconds
from repro_torch.core.autoscaler import Autoscaler, ScaleAction
from repro_torch.core.compiler import CompiledGraph
from repro_torch.core.datastore import DataEngine
from repro_torch.core.executor import (
    DRAINING,
    PROVISIONING,
    QUARANTINE,
    RESERVE,
    SERVING,
    WARMING,
    Executor,
    LocalBackend,
    OutOfMemory,
    ShardedBackend,
)
from repro_torch.core.faults import (
    DataFetchError,
    FaultPlane,
    RetryPolicy,
    TransientBackendError,
)
from repro_torch.core.profiles import ProfileStore, node_infer_time
from repro_torch.core.scheduler import ScheduledBatch, Scheduler
from repro_torch.core.telemetry import MetricsRegistry, default_registry
from repro_torch.core.tracing import COORDINATOR_PID, make_tracer
from repro_torch.core.transport import StagedInput, WorkerDied
from repro_torch.core.types import ValueRef, nbytes_of

PENDING, READY, RUNNING, AWAITING, DONE = "pending", "ready", "running", "awaiting", "done"
SHED = "shed"   # terminal: the node's request was shed (retry budget/strand)

_seq = itertools.count()

# -------------------------------------------------- pipeline overlap flag
#
# ``REPRO_OVERLAP=1`` lets the coordinator dispatch an ``overlappable``
# model (VAE decode) asynchronously onto an executor that is still
# running a denoise segment: the decode's compute hides under the
# segment's remaining window and the timeline pays only the EXPOSED
# remainder (``LatencyProfile.exposed_cost``).  Read at Coordinator
# construction, like the quant/donate flags are read at load time.

_overlap_enabled: bool = os.environ.get(
    "REPRO_OVERLAP", "0").lower() not in ("0", "false", "off", "")


def set_overlap(enabled: bool) -> bool:
    """Toggle denoise/decode pipeline overlap for Coordinators built
    after the call; returns the previous value."""
    global _overlap_enabled
    prev = _overlap_enabled
    _overlap_enabled = bool(enabled)
    return prev


def overlap_enabled() -> bool:
    return _overlap_enabled


class RequestNode:
    """Per-request instantiation of a compiled workflow node."""

    __slots__ = (
        "request", "node", "uid", "state", "pending_eager", "deferred_arrivals",
        "own_done_time", "executor_ids", "seq", "infer_est", "dispatch_time",
        "ready_since", "seg_done", "seg_state", "seg_pending",
        "retries", "dispatch_seq", "seg_commit",
    )

    def __init__(self, request: "Request", node: Any, infer_est: float) -> None:
        self.request = request
        self.node = node
        self.uid = f"{request.rid}:{node.id}"
        self.state = PENDING
        self.pending_eager = 0
        # deferred input key -> arrival time (None until the fetch resolves)
        self.deferred_arrivals: Dict[str, Optional[float]] = {}
        self.own_done_time: Optional[float] = None
        self.executor_ids: List[int] = []
        self.seq = next(_seq)
        self.infer_est = infer_est
        self.dispatch_time: Optional[float] = None
        self.ready_since: Optional[float] = None   # queueing-delay signal
        # segment progress (DenoiseSegment nodes execute in load-adaptive
        # chunks): steps already committed, the carried latent between
        # chunks, and the not-yet-committed result of the running chunk
        self.seg_done: int = 0
        self.seg_state: Optional[Any] = None
        self.seg_pending: Optional[Any] = None
        # hardening: requeue count against the retry budget, a dispatch
        # epoch so stale batch_done/timeout events can't act on a node
        # that was requeued and re-dispatched since, and the key/steps of
        # the last replicated segment commit (replicate-on-commit)
        self.retries: int = 0
        self.dispatch_seq: int = 0
        self.seg_commit: Optional[Tuple[str, int]] = None

    # ---- scheduling views -------------------------------------------------
    @property
    def model_id(self) -> str:
        return self.node.op.model_id

    @property
    def depth(self) -> int:
        return self.request.graph.depth[self.node.id]

    @property
    def arrival_time(self) -> float:
        return self.request.arrival

    @property
    def effective_patches(self) -> Tuple[str, ...]:
        """Patches whose async fetch already resolved (Katz semantics:
        early steps run unpatched; the adapter folds in when it arrives)."""
        want = self.node.attrs.get("patch_ids")
        if want is None:
            # no AsyncLoRAPass ran: patches apply synchronously at dispatch
            return tuple(p.model_id for p in self.node.op.patches)
        checks = self.node.attrs.get("lora_check", [])
        if all(c in self.request.lora_ready for c in checks):
            return tuple(want)
        return ()

    @property
    def batch_key(self) -> Tuple[str, Tuple[str, ...]]:
        return (self.model_id, self.effective_patches)

    @property
    def patches_pending(self) -> bool:
        """Adapters wanted but whose async fetch has not resolved yet.
        The scheduler bounds a segment's chunk to 1 while this holds, so
        the adapter folds in at the earliest step boundary — the fused
        equivalent of the unfused graph's per-step readiness checks."""
        want = self.node.attrs.get("patch_ids")
        if not want:
            return False
        checks = self.node.attrs.get("lora_check", [])
        return not all(c in self.request.lora_ready for c in checks)

    @property
    def segment_total(self) -> int:
        """Step count of a segment node's schedule (0 for ordinary nodes)."""
        if not getattr(self.node.op, "is_segment", False):
            return 0
        return len(self.node.inputs.get("t_mid") or ())

    @property
    def segment_remaining(self) -> Optional[int]:
        """Steps still to run, or None for non-segment nodes — what the
        scheduler's chunk policy reads."""
        total = self.segment_total
        if not total:
            return None
        return max(0, total - self.seg_done)

    def input_keys(self, eager_only: bool = True) -> List[str]:
        refs = self.node.eager_input_refs() if eager_only else self.node.all_input_refs()
        return [self.request.ref_key(r) for r in refs]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<RNode {self.uid} {self.model_id} {self.state}>"


class Request:
    def __init__(
        self,
        rid: int,
        graph: CompiledGraph,
        inputs: Dict[str, Any],
        arrival: float,
        slo_seconds: Optional[float],
        profiles: ProfileStore,
    ) -> None:
        self.rid = rid
        self.graph = graph
        self.inputs = inputs
        self.arrival = arrival
        self.slo_seconds = slo_seconds
        self.deadline = None if slo_seconds is None else arrival + slo_seconds
        self.workflow_name = graph.name
        self.nodes: Dict[int, RequestNode] = {}
        self.remaining = 0
        self.remaining_work = 0.0
        self.completion: Optional[float] = None
        self.status = "inflight"
        self.lora_ready: set = set()      # fetch-node ids whose I/O completed
        self.consumer_count: Dict[str, int] = {}
        self.output_values: Dict[str, Any] = {}
        for n in graph.nodes:
            est = 0.0
            if not (n.attrs.get("inline") or n.attrs.get("io_only")):
                est = node_infer_time(profiles, n)
            rn = RequestNode(self, n, est)
            self.nodes[n.id] = rn
            self.remaining += 1
            self.remaining_work += est
        # eager dependency counts + consumer refcounts
        for n in graph.nodes:
            rn = self.nodes[n.id]
            for ref in n.eager_input_refs():
                if ref.producer is not None:
                    rn.pending_eager += 1
            for ref in n.all_input_refs():
                key = self.ref_key(ref)
                self.consumer_count[key] = self.consumer_count.get(key, 0) + 1
        self.pinned_keys = {self.ref_key(ref) for ref in graph.outputs.values()}

    def ref_key(self, ref: ValueRef) -> str:
        if ref.is_input:
            return f"r{self.rid}:in:{ref.name}"
        return f"r{self.rid}:n{ref.producer}:{ref.port}"

    @property
    def latency(self) -> Optional[float]:
        return None if self.completion is None else self.completion - self.arrival

    @property
    def attained(self) -> Optional[bool]:
        if self.completion is None or self.deadline is None:
            return None
        return self.completion <= self.deadline


class Coordinator:
    def __init__(
        self,
        executors: List[Executor],
        profiles: ProfileStore,
        scheduler: Optional[Scheduler] = None,
        admission: Optional[AdmissionController] = None,
        backend: Optional[LocalBackend] = None,
        autoscaler: Optional[Autoscaler] = None,
        faults: Optional[FaultPlane] = None,
        retry_policy: Optional[RetryPolicy] = None,
        replicate_segments: bool = False,
        tracer: Optional[Any] = None,
        metrics: Optional[MetricsRegistry] = None,
        overlap: Optional[bool] = None,
    ) -> None:
        self.executors = executors
        self.by_id = {e.id: e for e in executors}
        self.profiles = profiles
        # executable plane defaults to the declared B_max (real stacked
        # forwards are measured, so the architectural cap governs); a
        # sharded backend also hands its MeshManager to the scheduler so
        # chosen k never exceeds an assemblable submesh
        self.scheduler = scheduler or Scheduler(
            profiles, use_declared_max_batch=backend is not None,
            mesh=getattr(backend, "mesh_manager", None))
        self.admission = admission or AdmissionController(profiles, enabled=False)
        self.backend = backend
        self.autoscaler = autoscaler
        self._tick_scheduled = False
        self._last_activity = 0.0
        # (t, n_serving) after every fleet transition — scaling timeline
        self.fleet_log: List[Tuple[float, int]] = []
        self.engine = DataEngine(profiles, pod_of={e.id: e.pod for e in executors})
        self.now = 0.0
        self.events: List[Tuple[float, int, str, Any]] = []
        self._ecount = itertools.count()
        self.ready: List[RequestNode] = []
        self.inflight: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self._rid = itertools.count()
        self.control_plane_time = 0.0     # wall seconds spent in handlers
        self.dispatch_log: List[ScheduledBatch] = []
        self._adapters_cached: set = set()
        # ------------------------------------------------- chaos/hardening
        # With no FaultPlane (explicit or via REPRO_FAULTS) the hardening
        # machinery is fully dormant: no timeout events, no backoff, no
        # quarantine — the default timeline is byte-identical to before.
        self.faults = faults if faults is not None else FaultPlane.from_env()
        self.retry = retry_policy or RetryPolicy()
        self.replicate_segments = replicate_segments
        self.engine.faults = self.faults
        self.engine.max_fetch_retries = self.retry.max_fetch_retries
        self.shed: List[Request] = []     # requests shed past retry budget
        self.n_submitted = 0
        self.n_timeouts = 0
        self.n_transient_retries = 0
        self.n_requeues = 0
        self.n_stranded = 0               # inflight shed at drained loop
        self._batch_index = 0             # dispatch counter (fault schedule)
        self._crashes_seeded = False
        # ------------------------------------------------- process plane
        # With a ProcBackend every executor is a separate OS process: the
        # backend binds to this coordinator (serialized datastore, shared
        # fault plane) and deaths are detected by heartbeat lease or RPC
        # failure instead of injected events
        self._proc = bool(getattr(backend, "is_proc_plane", False))
        self.n_worker_deaths = 0          # WorkerDied handled (all reasons)
        self.n_heartbeat_deaths = 0       # ... of which: lease expiry
        # ------------------------------------------------ pipeline overlap
        # REPRO_OVERLAP: decode of batch N rides an executor still running
        # batch N+1's denoise segment at exposed cost.  ``_seg_busy`` maps
        # executor id -> (segment window end, segment model id) for the
        # in-flight segment dispatch; ``_overlap_slot`` holds the window
        # end an overlapped dispatch already consumed (ONE overlap per
        # segment window — stacking more would hide unbounded work under
        # one window); ``_open_overlap`` keeps overlapped telemetry
        # records off the single-slot ``_open_batch`` so a decode span
        # never clobbers the segment span it overlaps.
        self.overlap = overlap_enabled() if overlap is None else bool(overlap)
        self.n_overlap_dispatches = 0
        self.overlap_hidden_seconds = 0.0
        self._seg_busy: Dict[int, Tuple[float, str]] = {}
        self._overlap_slot: Dict[int, float] = {}
        self._open_overlap: Dict[int, Dict[str, Any]] = {}
        # ------------------------------------------------- telemetry plane
        # The tracer is the REPRO_TELEMETRY-gated no-op singleton unless
        # tracing is on: every instrumentation site below guards on
        # ``self._tele`` so the disabled path builds no span arguments.
        # The metrics registry is always live — existing attribute
        # counters re-register as scrape-time providers at zero hot-path
        # cost (their ``self.n_x += 1`` call sites are untouched).
        self.tracer = tracer if tracer is not None else make_tracer()
        self._tele: bool = self.tracer.enabled
        self.metrics = metrics if metrics is not None else default_registry()
        # executor id -> open dispatch-span record, closed at the first
        # of batch_done / batch_timeout / executor failure so slices on
        # one executor track never partially overlap
        self._open_batch: Dict[int, Dict[str, Any]] = {}
        self._h_queue_delay = self.metrics.histogram(
            "coordinator_queue_delay_seconds",
            "ready -> dispatch delay per node", labelnames=("model",))
        self._register_telemetry()
        if hasattr(backend, "attach_coordinator"):
            backend.attach_coordinator(self)

    def _register_telemetry(self) -> None:
        """Re-register the runtime's ad-hoc counters onto the metrics
        registry as weakref providers (attribute APIs untouched)."""
        reg = self.metrics
        reg.register_object("coordinator", self, (
            "n_submitted", "n_timeouts", "n_transient_retries",
            "n_requeues", "n_stranded", "n_worker_deaths",
            "n_heartbeat_deaths", "control_plane_time",
            "n_overlap_dispatches", "overlap_hidden_seconds"))
        reg.register_object("datastore", self.engine, (
            "bytes_transferred", "num_transfers", "num_local_hits",
            "fetch_retries", "failed_fetches", "duplicate_puts",
            "ser_seconds", "serialized_bytes", "n_encodes", "n_decodes",
            "stage_evictions"))
        reg.register_object("scheduler", self.scheduler,
                            ("n_cycles", "n_batches"))
        for ex in self.executors:
            reg.register_object("executor", ex, (
                "n_failures", "n_quarantines", "n_revives",
                "models_loaded_count", "bytes_loaded", "busy_time"),
                labels={"executor": str(ex.id)})
        if self.backend is not None:
            reg.register_object("backend", self.backend, (
                "exec_seconds", "folded_evictions", "multilora_forwards",
                "n_injected_errors", "forward_log_dropped",
                # proc plane (missing attributes are skipped at scrape)
                "n_execs", "n_exec_replies", "n_exec_applied", "n_fenced",
                "ser_seconds", "transport_seconds", "worker_seconds",
                "restart_seconds", "staging_hits", "staging_ships",
                "bytes_shipped", "adapter_ships", "adapter_hits",
                "bytes_tx", "bytes_rx", "n_dup_frames",
                "n_delayed_frames", "crc_errors"))
            reg.register_object("adapter_pool", self.backend.adapter_pool,
                                ("hits", "misses", "evictions"))
        if self.autoscaler is not None:
            reg.register_object("autoscaler", self.autoscaler, (
                "n_quarantine_signals", "n_worker_death_signals"))
        if self.faults is not None:
            reg.register_object("faults", self.faults,
                                ("n_crashes", "n_kills"))

    # ------------------------------------------------------ telemetry API
    def export_trace(self, path: str, fmt: str = "chrome") -> None:
        """Write the recorded trace (``chrome`` for Perfetto, ``jsonl``
        for the raw span schema).  Raises if telemetry was disabled."""
        if fmt == "chrome":
            self.tracer.export_chrome(path)
        elif fmt == "jsonl":
            self.tracer.export_jsonl(path)
        else:
            raise ValueError(f"unknown trace format {fmt!r}")

    def metrics_text(self) -> str:
        """Prometheus text dump of the unified metrics registry."""
        return self.metrics.to_prometheus()

    def _close_batch_span(self, record: Dict[str, Any], status: str) -> None:
        """Close an open dispatch span at ``self.now`` (first of
        batch_done / batch_timeout / executor failure wins)."""
        t0 = record.pop("t0", None)
        if t0 is None:
            return
        batch: ScheduledBatch = record["batch"]
        eid = batch.executor_ids[0]
        overlapped = bool(record.get("overlap"))
        open_map = self._open_overlap if overlapped else self._open_batch
        if open_map.get(eid) is record:
            open_map.pop(eid, None)
        # overlapped decode spans live on their own sub-track: they run
        # CONCURRENTLY with the segment span on the executor's main
        # track, and slices within one track must never partially overlap
        track = f"exec{eid}:overlap" if overlapped else f"exec{eid}"
        rids = record.get("trace_rids") or []
        args = {"model": batch.model_id, "batch_size": batch.batch_size,
                "parallelism": batch.parallelism,
                "segment_steps": batch.segment_steps,
                "executors": list(batch.executor_ids),
                "rids": list(rids), "status": status}
        if overlapped:
            args["overlap_window"] = batch.overlap_window
        self.tracer.span(
            f"dispatch {batch.model_id}", t0, self.now - t0,
            COORDINATOR_PID, track, cat="dispatch",
            trace=rids[0] if rids else None, args=args)
        for rid in rids:
            self.tracer.flow(rid, t0, COORDINATOR_PID, track)

    # ----------------------------------------------------------- frontend
    def submit(
        self,
        graph: CompiledGraph,
        inputs: Optional[Dict[str, Any]] = None,
        arrival: Optional[float] = None,
        slo_seconds: Optional[float] = None,
    ) -> Request:
        rid = next(self._rid)
        req = Request(rid, graph, inputs or {}, arrival if arrival is not None else self.now,
                      slo_seconds, self.profiles)
        self.n_submitted += 1
        self._push(req.arrival, "arrival", req)
        return req

    def fail_executor(self, executor_id: int, at: float) -> None:
        self._push(at, "executor_fail", executor_id)

    # -------------------------------------------------------------- engine
    def _push(self, t: float, kind: str, payload: Any) -> None:
        heapq.heappush(self.events, (t, next(self._ecount), kind, payload))

    def run(self, until: Optional[float] = None) -> None:
        if self.faults is not None and not self._crashes_seeded:
            # explicit virtual-time crash schedule from the fault plane
            self._crashes_seeded = True
            for t_crash, eid in self.faults.crash_at:
                self._push(t_crash, "executor_fail", eid)
        if self.autoscaler is not None and not self._tick_scheduled and self.events:
            # anchor the control loop at the first event of this run
            self._tick_scheduled = True
            self._push(self.events[0][0], "autoscale_tick", None)
        while self.events:
            if self._proc:
                # wall-clock liveness sweep: drain idle worker channels
                # (stale replies found there are fenced) and declare any
                # exited/silent worker dead before the next event runs
                for err in self.backend.poll_liveness():
                    self._handle_worker_death(err)
            t, _, kind, payload = self.events[0]
            if until is not None and t > until:
                break
            heapq.heappop(self.events)
            self.now = max(self.now, t)
            t0 = _time.perf_counter()
            getattr(self, f"_on_{kind}")(payload)
            if kind != "autoscale_tick":
                self._last_activity = self.now
            self._schedule_cycle()
            self.control_plane_time += _time.perf_counter() - t0
        if (until is None and self.faults is not None and not self.events
                and self.inflight):
            # run-to-completion with chaos on: the loop drained with work
            # still inflight (e.g. every executor died and nothing will
            # revive).  Terminate those requests exactly once as shed so
            # the exactly-once invariant holds; n_stranded exposes it.
            for req in list(self.inflight.values()):
                self.n_stranded += 1
                self._shed_request(req)

    # -------------------------------------------------------------- events
    def _on_arrival(self, req: Request) -> None:
        backlog = sum(r.remaining_work for r in self.inflight.values())
        if self._tele:
            self.tracer.begin_request(
                req.rid, f"r{req.rid} {req.workflow_name}", self.now,
                args={"workflow": req.workflow_name,
                      "slo_seconds": req.slo_seconds})
        if not self.admission.decide(self.now, req.graph, req.slo_seconds,
                                     backlog, self.n_schedulable):
            req.status = "rejected"
            self.rejected.append(req)
            if self._tele:
                self.tracer.instant(
                    "rejected", self.now, COORDINATOR_PID, "control",
                    cat="admission", trace=req.rid,
                    args={"backlog": backlog})
                self.tracer.end_request(
                    req.rid, f"r{req.rid} {req.workflow_name}", self.now,
                    status="rejected")
            if self.autoscaler is not None:
                # shed demand is still demand: attribute it to the models
                # the request would have run so the fleet can grow
                self.autoscaler.note_rejection(self.now, [
                    n.op.model_id for n in req.graph.nodes
                    if not (n.attrs.get("inline") or n.attrs.get("io_only"))
                ])
            return
        self.inflight[req.rid] = req
        # materialize workflow inputs in the (frontend) data store
        for name in req.graph.input_ports:
            key = f"r{req.rid}:in:{name}"
            value = req.inputs.get(name)
            self.engine.put(
                key, executor_id=None, nbytes=nbytes_of(value) if value is not None else 64,
                value=value, refcount=req.consumer_count.get(key, 0) + 1,
            )
        for n in req.graph.nodes:
            rn = req.nodes[n.id]
            if rn.pending_eager == 0:
                self._node_ready(rn)

    def _on_io_done(self, rnode: RequestNode) -> None:
        rnode.request.lora_ready.add(rnode.node.id)
        self._complete_node(rnode, self.now)

    def _on_batch_done(self, record: Dict[str, Any]) -> None:
        if record.get("done"):
            return  # the paired timeout already reclaimed this batch
        record["done"] = True
        if self._tele:
            self._close_batch_span(record, "done")
        batch: ScheduledBatch = record["batch"]
        seqs = record.get("seqs")
        for rnode in batch.nodes:
            if rnode.state != RUNNING:
                continue  # e.g. requeued after executor failure
            if seqs is not None and seqs.get(rnode.uid) != rnode.dispatch_seq:
                # stale epoch: the node was requeued (executor failure or
                # timeout) and re-dispatched since this event was pushed —
                # completing it here would double-apply under the wrong batch
                continue
            if rnode.segment_total and self._advance_segment(rnode, batch):
                continue  # chunk committed; steps remain — re-chunked
            rnode.own_done_time = self.now
            self._try_finish_running_node(rnode)

    def _advance_segment(self, rnode: RequestNode, batch: ScheduledBatch) -> bool:
        """Commit a finished segment chunk.  Returns True when steps
        remain — the node goes back to READY and the next scheduling
        cycle re-chunks the request's remaining steps against the queue
        depth it sees THEN (load-adaptive granularity, §5.2)."""
        total = rnode.segment_total
        rnode.seg_done = min(total, rnode.seg_done + max(1, batch.segment_steps))
        finished = rnode.seg_done >= total
        if self.backend is not None and rnode.seg_pending is not None:
            out, rnode.seg_pending = rnode.seg_pending, None
            if finished:
                rnode.request.output_values[rnode.uid] = out
            else:
                rnode.seg_state = out.get("latents")
                if self.replicate_segments:
                    self._commit_segment_state(rnode)
        if finished:
            return False
        rnode.state = READY
        rnode.executor_ids = []
        rnode.own_done_time = None
        rnode.ready_since = self.now
        self.ready.append(rnode)
        return True

    def _commit_segment_state(self, rnode: RequestNode) -> None:
        """Replicate-on-commit (opt-in): place the committed carried
        latent in the data store with a synchronous second copy on
        another serving executor.  Losing the lead executor then costs a
        re-run of the *uncommitted chunk only* — `_reexecute` resumes
        from the latest surviving commit instead of replaying the whole
        denoise chain from its inputs."""
        if rnode.seg_state is None or not rnode.executor_ids:
            return
        req = rnode.request
        lead = rnode.executor_ids[0]
        backup = next((e.id for e in self.executors
                       if e.is_serving and e.id != lead), None)
        key = f"r{req.rid}:n{rnode.node.id}:segc:{rnode.seg_done}"
        old = rnode.seg_commit
        self.engine.put(key, executor_id=lead, nbytes=nbytes_of(rnode.seg_state),
                        value=rnode.seg_state, refcount=1, replicate_to=backup)
        rnode.seg_commit = (key, rnode.seg_done)
        if old is not None:
            self._drop_key(old[0])  # superseded commit

    def _drop_key(self, key: str) -> None:
        if self.engine.exists(key):
            # force-drop: one reference left, released now (going through
            # release() keeps the refcount watermark invariant clean)
            self.engine.get(key).refcount = 1
            self.engine.release(key)

    def _on_node_late_complete(self, rnode: RequestNode) -> None:
        if rnode.state in (RUNNING, AWAITING):
            self._complete_node(rnode, self.now)

    def _on_executor_fail(self, executor_id: int) -> None:
        self._fail_executor_now(executor_id, kill_process=True)

    def _handle_worker_death(self, err: WorkerDied) -> None:
        """Process plane: a worker left its fault domain (exit, heartbeat
        lease expiry, or RPC stall).  The process is already dead or
        partitioned, so it is NOT re-killed: a live-but-silent zombie is
        adopted by the recovery path with a bumped epoch, precisely so
        its late frames surface and get fenced."""
        ex = self.by_id.get(err.executor_id)
        if ex is None or not ex.alive:
            return     # already declared (e.g. RPC raised, sweep re-saw it)
        self.n_worker_deaths += 1
        if err.reason == "heartbeat":
            self.n_heartbeat_deaths += 1
        if self._tele:
            self.tracer.instant(
                "worker_death", self.now, COORDINATOR_PID, "control",
                cat="fault", args={"executor": err.executor_id,
                                   "reason": err.reason,
                                   "pid": ex.worker_pid})
        self._fail_executor_now(err.executor_id, kill_process=False)

    def _fail_executor_now(self, executor_id: int, kill_process: bool) -> None:
        ex = self.by_id[executor_id]
        if not ex.alive:
            return  # double fail event (e.g. crash_at + crash_every collide)
        if self._tele:
            for open_rec in (self._open_batch.get(executor_id),
                             self._open_overlap.get(executor_id)):
                if open_rec is not None:
                    self._close_batch_span(open_rec, "executor_fail")
            self.tracer.instant(
                "executor_fail", self.now, COORDINATOR_PID, "control",
                cat="fault", args={"executor": executor_id,
                                   "killed": kill_process})
        resident = list(ex.loaded)
        ex.fail()
        # the in-flight segment window died with the executor: no decode
        # may overlap it, and a revived executor starts with a clean slot
        self._seg_busy.pop(executor_id, None)
        self._overlap_slot.pop(executor_id, None)
        if self._proc and kill_process:
            # control-plane-initiated failure of a real fault domain: the
            # worker process actually dies (chaos crash events included)
            self.backend.kill_worker(executor_id)
        if self.faults is not None or self._proc:
            ex.note_failure(self.now, self.retry.quarantine_window)
        revive_delay: Optional[float] = None
        if self._proc:
            # supervised recovery: the worker always comes back — respawn
            # wall seconds (measured; 0 for an adopted zombie) gate the
            # revive, combined with any virtual revive_after schedule
            wall = self.backend.recover_worker(executor_id)
            virtual = 0.0
            if self.faults is not None and self.faults.revive_after is not None:
                virtual = self.faults.revive_after
            revive_delay = max(wall, virtual)
        elif self.faults is not None and self.faults.revive_after is not None:
            revive_delay = self.faults.revive_after
        if revive_delay is not None:
            self._push(self.now + revive_delay, "executor_revive", executor_id)
        if self._proc and self.autoscaler is not None and resident:
            # lost capacity is a demand signal, same as a quarantine drain
            self.autoscaler.note_worker_death(self.now, resident)
        self._log_fleet()
        # requeue nodes that were running there (with chaos on, the
        # requeue counts against the retry budget and backs off)
        victims = [
            rn for req in self.inflight.values() for rn in req.nodes.values()
            if rn.state in (RUNNING, AWAITING) and executor_id in rn.executor_ids
        ]
        self._requeue_nodes(victims,
                            count_retry=self.faults is not None or self._proc)
        # lineage-based recovery of lost values
        lost = self.engine.executor_lost(executor_id)
        for key, lineage in lost:
            if lineage is None:
                continue
            rid_s, nid_s = lineage.split(":")
            req = self.inflight.get(int(rid_s))
            if req is None:
                continue
            self._reexecute(req.nodes[int(nid_s)])
        if lost:
            # READY nodes may have lost an eager input whose producer ran
            # on a *different* failed executor — dispatching them would
            # read a missing key.  Send them back to PENDING and rebuild.
            self._rescue_ready_nodes({key for key, _ in lost})

    def _on_executor_revive(self, executor_id: int) -> None:
        """Process restart ``revive_after`` seconds after a crash: the
        executor rejoins with cold caches.  A crash-looping executor
        (enough failure marks still inside the window) goes straight to
        quarantine instead of flapping back into the dispatch pool."""
        ex = self.by_id[executor_id]
        if ex.alive:
            return
        ex.revive(self.now)
        if self._tele:
            self.tracer.instant(
                "revive", self.now, COORDINATOR_PID, "control",
                cat="recovery", args={"executor": executor_id})
        self._log_fleet()
        self._maybe_quarantine(ex)

    def _rescue_ready_nodes(self, lost_keys: set) -> None:
        for req in self.inflight.values():
            for rn in req.nodes.values():
                if rn.state != READY:
                    continue
                missing = [ref for ref in rn.node.eager_input_refs()
                           if req.ref_key(ref) in lost_keys
                           and not self.engine.exists(req.ref_key(ref))]
                if not missing:
                    continue
                rn.state = PENDING
                rn.ready_since = None
                if rn in self.ready:
                    self.ready.remove(rn)
                rn.pending_eager = sum(
                    1 for ref in rn.node.eager_input_refs()
                    if ref.producer is not None
                    and not self.engine.exists(req.ref_key(ref)))
                for ref in missing:
                    if ref.producer is not None:
                        self._reexecute(req.nodes[ref.producer])
                # an inline producer re-executed above completes at once and
                # wakes this node itself: ready it only if nothing did
                if rn.state == PENDING and rn.pending_eager == 0:
                    self._node_ready(rn)

    def _reexecute(self, rnode: RequestNode) -> None:
        """Reset a DONE node (and missing ancestors) so it runs again."""
        if rnode.state in (READY, RUNNING, AWAITING):
            return
        req = rnode.request
        if self._tele:
            self.tracer.instant(
                "replay", self.now, COORDINATOR_PID, "control",
                cat="recovery", trace=req.rid,
                args={"uid": rnode.uid, "seg_done": rnode.seg_done})
        was = rnode.state
        for ref in rnode.node.eager_input_refs():
            if (ref.producer is not None
                    and not self.engine.exists(req.ref_key(ref))):
                self._reexecute(req.nodes[ref.producer])
        if rnode.state != was:
            return      # a PENDING node that the recursion woke is queued
        if rnode.state == DONE:
            req.remaining += 1
            req.remaining_work += rnode.infer_est
        rnode.state = PENDING
        rnode.own_done_time = None
        rnode.executor_ids = []
        rnode.deferred_arrivals.clear()
        restored = False
        if rnode.seg_commit is not None:
            ckey, csteps = rnode.seg_commit
            if self.engine.exists(ckey):
                # replicate-on-commit survivor: resume the segment from
                # the latest committed chunk boundary
                rnode.seg_done = csteps
                rnode.seg_state = self.engine.value_of(ckey)
                restored = True
            else:
                rnode.seg_commit = None
        if not restored:
            rnode.seg_done = 0           # lineage recovery replays the
            rnode.seg_state = None       # whole segment from its inputs
        rnode.seg_pending = None
        rnode.pending_eager = sum(
            1 for ref in rnode.node.eager_input_refs()
            if ref.producer is not None and not self.engine.exists(req.ref_key(ref))
        )
        # restore consumer refcounts on surviving inputs
        for ref in rnode.node.all_input_refs():
            key = req.ref_key(ref)
            if self.engine.exists(key):
                self.engine.addref(key)
        # read after the recursion: an inline producer re-executed there
        # restores its output at once, and a missing input with no
        # producer never comes back
        if rnode.pending_eager == 0 and all(
                self.engine.exists(req.ref_key(ref))
                for ref in rnode.node.eager_input_refs()):
            self._node_ready(rnode)

    # -------------------------------------------------- hardening/chaos
    def _requeue_nodes(self, nodes: List[RequestNode], count_retry: bool) -> None:
        """Send failed/timed-out nodes back to the queue.  With
        ``count_retry`` the requeue counts against the per-node retry
        budget (exhaustion sheds the whole request, exactly once) and
        re-admission waits out a capped exponential backoff."""
        for rn in list(nodes):
            req = rn.request
            if req.status != "inflight" or rn.state not in (RUNNING, AWAITING, READY):
                continue
            if count_retry:
                rn.retries += 1
                self.n_requeues += 1
                if self._tele:
                    self.tracer.instant(
                        "requeue", self.now, COORDINATOR_PID, "control",
                        cat="retry", trace=req.rid,
                        args={"uid": rn.uid, "retries": rn.retries})
                if rn.retries > self.retry.node_retry_budget:
                    self._shed_request(req)
                    continue
            rn.state = READY
            rn.executor_ids = []
            rn.own_done_time = None
            rn.seg_pending = None        # uncommitted chunk re-runs
            rn.deferred_arrivals.clear()
            rn.ready_since = self.now
            delay = self.retry.backoff(rn.retries) if count_retry else 0.0
            if delay > 0.0:
                self._push(self.now + delay, "requeue_release",
                           (rn, rn.dispatch_seq))
            elif rn not in self.ready:
                self.ready.append(rn)

    def _on_kick(self, _payload: Any) -> None:
        """No-op event: exists so a recovery performed mid-cycle gets a
        scheduling cycle of its own (the run loop cycles after every
        event)."""

    def _on_requeue_release(self, payload: Tuple[RequestNode, int]) -> None:
        rn, token = payload
        if (rn.request.status != "inflight" or rn.state != READY
                or rn.dispatch_seq != token or rn in self.ready):
            return  # shed, rescued to PENDING, or re-dispatched meanwhile
        self.ready.append(rn)

    def _on_batch_timeout(self, record: Dict[str, Any]) -> None:
        """The batch never reported completion within its deadline
        (hung/runaway forward, or its completion event belongs to a
        failed path).  Cancel the executors' runaway work, mark them for
        quarantine accounting, and requeue the still-running nodes."""
        if record.get("done"):
            return
        record["done"] = True
        self.n_timeouts += 1
        if self._tele:
            self._close_batch_span(record, "timeout")
        batch: ScheduledBatch = record["batch"]
        for eid in batch.executor_ids:
            ex = self.by_id.get(eid)
            if ex is None or not ex.alive:
                continue
            if not record.get("overlap"):
                # an overlapped decode shares its executor with the
                # in-flight segment: cancelling would reclaim the
                # SEGMENT's reservation too, so only a non-overlapped
                # runaway frees the device early
                ex.cancel(self.now)
            self._note_executor_failure(ex)
        stale = [rn for rn in batch.nodes
                 if rn.state == RUNNING
                 and record["seqs"].get(rn.uid) == rn.dispatch_seq]
        self._requeue_nodes(stale, count_retry=True)

    def _note_executor_failure(self, ex: Executor) -> None:
        if self.faults is None and not self._proc:
            return
        ex.note_failure(self.now, self.retry.quarantine_window)
        self._maybe_quarantine(ex)

    def _maybe_quarantine(self, ex: Executor) -> None:
        if (self.faults is None and not self._proc) \
                or not ex.alive or ex.state != SERVING:
            return
        horizon = self.now - self.retry.quarantine_window
        recent = sum(1 for t in ex.failure_times if t >= horizon)
        if recent < self.retry.quarantine_failures:
            return
        models = list(ex.loaded)
        ex.begin_quarantine()
        if self._tele:
            self.tracer.instant(
                "quarantine", self.now, COORDINATOR_PID, "control",
                cat="fault", args={"executor": ex.id, "models": models})
        if self.autoscaler is not None:
            # drained capacity is a demand signal: the fleet may need to
            # re-provision these models elsewhere while the cooldown runs
            self.autoscaler.note_quarantine(self.now, models)
        self._log_fleet()
        self._push(self.now + self.retry.quarantine_seconds,
                   "quarantine_release", ex.id)

    def _on_quarantine_release(self, executor_id: int) -> None:
        ex = self.by_id[executor_id]
        if not ex.alive or ex.state != QUARANTINE:
            return
        ex.release_quarantine()
        self._log_fleet()

    def _shed_request(self, req: Request) -> None:
        """Terminal give-up: the request leaves the system exactly once
        with status ``shed`` (counted against SLO attainment), and every
        value it still holds is reclaimed."""
        if req.status != "inflight":
            return
        req.status = "shed"
        self.inflight.pop(req.rid, None)
        self.shed.append(req)
        if self._tele:
            self.tracer.instant(
                "shed", self.now, COORDINATOR_PID, "control",
                cat="retry", trace=req.rid, args={})
            self.tracer.end_request(
                req.rid, f"r{req.rid} {req.workflow_name}", self.now,
                status="shed")
        for rn in req.nodes.values():
            if rn.state != DONE:
                rn.state = SHED
            if rn in self.ready:
                self.ready.remove(rn)
        leftovers = [f"r{req.rid}:in:{name}" for name in req.graph.input_ports]
        for n in req.graph.nodes:
            leftovers.extend(req.ref_key(ref) for ref in n.output_refs.values())
        leftovers.extend(rn.seg_commit[0] for rn in req.nodes.values()
                         if rn.seg_commit is not None)
        for key in leftovers:
            self._drop_key(key)

    def _recover_lost_fetch(self, err: DataFetchError) -> None:
        """A datastore transfer failed past its budget and dropped the
        key: re-execute the producer (lineage recovery) and pull any
        READY consumer of the key back to PENDING."""
        if err.lineage is not None:
            rid_s, nid_s = err.lineage.split(":")
            req = self.inflight.get(int(rid_s))
            if req is not None:
                self._reexecute(req.nodes[int(nid_s)])
        self._rescue_ready_nodes({err.key})

    # ---------------------------------------------------------- autoscaling
    @property
    def n_schedulable(self) -> int:
        """Capacity view for admission: executors serving now or within one
        warm-up (provisioning/warming).  Cold reserves don't count."""
        return sum(1 for e in self.executors
                   if e.alive and e.state in (SERVING, WARMING, PROVISIONING))

    def _log_fleet(self) -> None:
        self.fleet_log.append(
            (self.now, sum(1 for e in self.executors if e.is_serving)))

    def _on_autoscale_tick(self, _payload: Any) -> None:
        self._tick_scheduled = False
        asc = self.autoscaler
        if asc is None:
            return
        actions = asc.decide(self.now, self.ready, self.executors)
        for a in actions:
            self._apply_scale_action(a)
        if actions:
            self._last_activity = self.now
        cfg = asc.config
        transitional = any(
            e.alive and e.state in (PROVISIONING, WARMING, DRAINING)
            for e in self.executors)
        # keep ticking while work remains, transitions are in flight, or a
        # scale-down could still fire (bounded linger past the last action,
        # so the loop always terminates once the fleet settles).  Inflight
        # work only counts if the fleet can still make progress — with
        # every executor dead, ticking would spin forever
        linger = cfg.down_idle_seconds + cfg.down_cooldown + 2 * cfg.tick_interval
        can_progress = self.inflight and any(e.alive for e in self.executors)
        if (self.events or can_progress or transitional
                or self.now - self._last_activity < linger):
            self._tick_scheduled = True
            self._push(self.now + cfg.tick_interval, "autoscale_tick", None)

    def _apply_scale_action(self, action: ScaleAction) -> None:
        ex = self.by_id[action.executor_id]
        if action.kind == "scale_up":
            if not ex.alive or ex.state not in (RESERVE, SERVING):
                return
            ex.begin_provisioning(action.model_id)
            self._log_fleet()
            self._push(self.now + self.autoscaler.config.provision_delay,
                       "provision_done", ex.id)
        else:  # scale_down: drain, then evict/retire
            if not ex.alive or ex.state != SERVING:
                return
            ex.begin_draining(action.model_id)
            self._log_fleet()
            if ex.busy_until <= self.now:
                self._finish_drain(ex)
            else:
                self._push(ex.busy_until, "drain_done", ex.id)

    def _on_provision_done(self, executor_id: int) -> None:
        ex = self.by_id[executor_id]
        if not ex.alive or ex.state != PROVISIONING:
            return
        ex.begin_warming()
        mid = ex.warming_model
        load = self.profiles.get(mid).load_time() if self.profiles.known(mid) else 0.0
        self._push(self.now + load, "warm_done", executor_id)

    def _on_warm_done(self, executor_id: int) -> None:
        """Warm-pool handoff: weights are resident *before* the executor is
        opened for dispatch, so its first batch pays L_load = 0."""
        ex = self.by_id[executor_id]
        if not ex.alive or ex.state != WARMING:
            return
        mid = ex.warming_model
        nbytes = self.profiles.get(mid).param_bytes if self.profiles.known(mid) else 0.0
        ex.ensure_capacity(nbytes)     # evict idle LRU residents if needed
        ex.finish_warming(nbytes)
        self._log_fleet()

    def _on_drain_done(self, executor_id: int) -> None:
        ex = self.by_id[executor_id]
        if not ex.alive or ex.state != DRAINING:
            return
        if ex.busy_until <= self.now:
            self._finish_drain(ex)
        else:   # deferred fetches extended the batch; retry at the new end
            self._push(ex.busy_until, "drain_done", executor_id)

    def _finish_drain(self, ex: Executor) -> None:
        ex.finish_draining()
        self._log_fleet()

    # ----------------------------------------------------------- lifecycle
    def _node_ready(self, rnode: RequestNode) -> None:
        attrs = rnode.node.attrs
        if attrs.get("inline"):
            rnode.state = RUNNING
            rnode.own_done_time = self.now
            self._complete_node(rnode, self.now)
        elif attrs.get("io_only"):
            rnode.state = RUNNING
            cost = rnode.node.op.cost()
            dur = cost.act_io_bytes / self.profiles.hw.remote_bw
            self._push(self.now + dur, "io_done", rnode)
        else:
            rnode.state = READY
            rnode.ready_since = self.now
            self.ready.append(rnode)

    def _overlap_candidates(self) -> List[Executor]:
        """Busy executors an overlappable model may ride (REPRO_OVERLAP):
        still inside an in-flight denoise-segment window, with that
        window's single overlap slot unconsumed."""
        if not self.overlap:
            return []
        out: List[Executor] = []
        for e in self.executors:
            if not e.is_serving or e.is_free(self.now):
                continue
            seg = self._seg_busy.get(e.id)
            if seg is None or seg[0] <= self.now:
                continue
            if self._overlap_slot.get(e.id) == seg[0]:
                continue
            out.append(e)
        return out

    def _schedule_cycle(self) -> None:
        if not self.ready:
            return
        free = [e for e in self.executors if e.is_free(self.now)]
        # None = overlap off; [] = on but no mid-flight candidates yet
        # (the scheduler may still mint in-cycle candidates from segment
        # dispatches, which need a free executor anyway)
        overlap_pool = self._overlap_candidates() if self.overlap else None
        if not free and not overlap_pool:
            return
        if self.backend is not None:
            # executable plane really needs input VALUES: hold nodes whose
            # deferred producers have not finished (timing overlap is the
            # sim plane's concern; correctness rules here)
            def deferred_ready(rn):
                req = rn.request
                for ref in rn.node.deferred_input_refs():
                    if ref.producer is not None and \
                            req.nodes[ref.producer].state != DONE:
                        return False
                return True
            runnable = [rn for rn in self.ready if deferred_ready(rn)]
            if not runnable:
                return
            held = [rn for rn in self.ready if not deferred_ready(rn)]
            self.ready[:] = runnable
            try:
                self._dispatch_cycle(free, overlap_pool)
            finally:
                self.ready.extend(held)
            return
        self._dispatch_cycle(free, overlap_pool)

    def _dispatch_cycle(self, free, overlap_pool=None) -> None:

        def fetch_cost(batch: List[RequestNode], executor_id: int) -> float:
            keys: List[str] = []
            for rn in batch:
                keys.extend(rn.input_keys(eager_only=True))
            return self.engine.batch_fetch_cost(keys, executor_id)

        n_serving = sum(1 for e in self.executors if e.is_serving)
        low_load = len(self.inflight) < n_serving
        decisions = self.scheduler.schedule_cycle(self.ready, free, fetch_cost,
                                                  low_load=low_load,
                                                  overlap=overlap_pool,
                                                  now=self.now)
        for d in decisions:
            self._dispatch(d)


    def _dispatch(self, batch: ScheduledBatch) -> None:
        self.dispatch_log.append(batch)
        batch_index = self._batch_index
        self._batch_index += 1
        fault = (self.faults.at_dispatch(batch_index, self.now)
                 if self.faults is not None else None)
        lead = self.by_id[batch.executor_ids[0]]
        profile = self.profiles.get(batch.model_id)
        overlapped = batch.overlap_window > 0.0
        # model loads + patch state on every participating executor
        for eid in batch.executor_ids:
            ex = self.by_id[eid]
            if not ex.has_model(batch.model_id):
                # dispatch targets are free, so every resident model is idle
                # and LRU-evictable to make room — except on an overlapped
                # dispatch, where the in-flight segment's model is live
                # and must survive the decode load
                protected = None
                if overlapped:
                    seg = self._seg_busy.get(eid)
                    protected = {seg[1]} if seg is not None else None
                try:
                    ex.ensure_capacity(profile.param_bytes,
                                       protected=protected)
                except OutOfMemory:
                    if not overlapped:
                        raise
                    # the decode cannot fit beside the running segment:
                    # burn this window's slot and requeue for a normal
                    # (free-executor) dispatch
                    if eid in self._seg_busy:
                        self._overlap_slot[eid] = self._seg_busy[eid][0]
                    self._requeue_nodes(batch.nodes, count_retry=False)
                    self._push(self.now, "kick", None)
                    return
                ex.mark_loaded(batch.model_id, profile.param_bytes)
            else:
                ex.touch(batch.model_id)
            if not batch.multilora:
                # grouped multi-LoRA batches never mutate the executor's
                # folded patch state: per-request adapters ride the
                # backend's adapter pool, the resident base stays pristine
                ex.set_patches(batch.model_id, list(batch.nodes[0].effective_patches))
        # account input fetches into the lead executor's store (chaos: a
        # transfer may be lost in flight past its retry budget)
        try:
            for rn in batch.nodes:
                for key in rn.input_keys(eager_only=True):
                    if self.engine.exists(key):
                        self.engine.fetch(key, lead.id)
        except DataFetchError as err:
            self._requeue_nodes(batch.nodes, count_retry=False)
            self._recover_lost_fetch(err)
            # this failure happened *inside* a scheduling cycle: kick the
            # loop so the requeued/recovered nodes get a fresh cycle even
            # if no other event is pending
            self._push(self.now, "kick", None)
            return
        duration = batch.duration
        # synchronous adapter fetch (no AsyncLoRAPass): the first dispatch
        # of a patched node on an executor pays the remote fetch inline
        for rn in batch.nodes:
            if rn.node.op.patches and not rn.node.attrs.get("lora_check"):
                for patch in rn.node.op.patches:
                    ckey = (lead.id, patch.model_id)
                    if ckey not in self._adapters_cached:
                        self._adapters_cached.add(ckey)
                        duration += patch.cost().param_bytes / self.profiles.hw.remote_bw
        if fault == "transient":
            attempts = self.faults.transient_attempts(batch_index)
            if self.backend is not None:
                # the backend itself raises; retry the stacked forward
                # around the injected errors with capped backoff
                try:
                    real = self._execute_real_hardened(batch, attempts)
                except WorkerDied as err:
                    self._abort_dispatch_on_death(batch, err)
                    return
                if real is None:
                    # persisted past the in-dispatch budget: fall back to
                    # the requeue path (counts against the retry budget)
                    self._requeue_nodes(batch.nodes, count_retry=True)
                    return
                measured, penalty = real
                duration = measured + batch.l_data + batch.patch_swap + penalty
            else:
                retries = min(attempts, self.retry.max_transient_retries)
                self.n_transient_retries += retries
                if attempts > self.retry.max_transient_retries:
                    for eid in batch.executor_ids:
                        self._note_executor_failure(self.by_id[eid])
                    self._requeue_nodes(batch.nodes, count_retry=True)
                    return
                duration += sum(self.retry.backoff(i) for i in range(1, retries + 1))
        elif self.backend is not None and fault != "hang":
            try:
                duration = self._execute_real(batch) + batch.l_data + batch.patch_swap
            except WorkerDied as err:
                self._abort_dispatch_on_death(batch, err)
                return
        if overlapped:
            # async decode under the in-flight segment window: the hidden
            # portion of the (measured or modeled) cost rides the window
            # for free, only the exposed remainder occupies the timeline.
            # The sim plane's l_infer is already exposed-priced by the
            # scheduler; the executable plane's measured wall is not.
            # Price against the ACTUAL remaining busy horizon — the
            # segment the decision chased has executed (measured) by now,
            # so the estimate in batch.overlap_window may be stale.
            window = max(0.0, max(
                self.by_id[eid].busy_until for eid in batch.executor_ids)
                - self.now)
            if self.backend is not None and fault != "hang":
                full = duration
                duration = profile.exposed_cost(duration, window)
                self.overlap_hidden_seconds += max(0.0, full - duration)
            else:
                self.overlap_hidden_seconds += max(
                    0.0, profile.infer_time(batch.batch_size, 1)
                    - batch.l_infer)
            self.n_overlap_dispatches += 1
        # a hung forward never reports back: occupy for the modeled
        # duration but push no completion — only the timeout recovers it
        base_duration = duration
        if fault == "slow":
            # gray failure: trips the timeout iff slow_factor > timeout_factor
            duration *= self.faults.slow_factor
        done_at = self.now + duration
        for eid in batch.executor_ids:
            end = self.by_id[eid].occupy(self.now, duration)
            if overlapped:
                # the exposed occupancy APPENDS at the executor's busy
                # horizon (the segment still owns the device until then):
                # the decode surfaces at window end + exposed cost
                done_at = max(done_at, end)
        # virtual start of this dispatch's own occupancy window — equals
        # ``now`` for a normal dispatch; timeout/crash anchor to it so an
        # overlapped decode is not timed out while merely hidden
        start = done_at - duration
        if overlapped:
            for eid in batch.executor_ids:
                if eid in self._seg_busy:
                    self._overlap_slot[eid] = self._seg_busy[eid][0]
        elif getattr(batch.nodes[0].node.op, "is_segment", False):
            # a fresh segment window opens: overlappable work may ride it
            for eid in batch.executor_ids:
                self._seg_busy[eid] = (self.by_id[eid].busy_until,
                                       batch.model_id)
        record: Dict[str, Any] = {"batch": batch, "seqs": {}, "done": False}
        if overlapped:
            record["overlap"] = True
        if self._tele:
            # open the dispatch span now; it closes (and records) at the
            # first of batch_done / batch_timeout / executor failure, so
            # slices on one executor track always nest (overlapped spans
            # live in _open_overlap / their own sub-track)
            record["t0"] = self.now
            record["trace_rids"] = sorted(
                {rn.request.rid for rn in batch.nodes})
            if overlapped:
                self._open_overlap[batch.executor_ids[0]] = record
            else:
                self._open_batch[batch.executor_ids[0]] = record
            h = self._h_queue_delay.labels(batch.model_id)
            for rn in batch.nodes:
                if rn.ready_since is not None:
                    h.observe(self.now - rn.ready_since)
        for rn in batch.nodes:
            rn.state = RUNNING
            rn.executor_ids = list(batch.executor_ids)
            rn.dispatch_time = self.now
            rn.dispatch_seq += 1
            record["seqs"][rn.uid] = rn.dispatch_seq
        if fault != "hang":
            self._push(done_at, "batch_done", record)
        if self.faults is not None:
            timeout = max(self.retry.timeout_floor,
                          self.retry.timeout_factor * base_duration)
            self._push(start + timeout, "batch_timeout", record)
        if fault == "crash":
            # the lead executor dies partway through the batch window
            self._push(start + self.faults.crash_frac * duration,
                       "executor_fail", lead.id)

    def _abort_dispatch_on_death(self, batch: ScheduledBatch,
                                 err: WorkerDied) -> None:
        """The worker serving this dispatch died mid-RPC — before any of
        the batch's nodes flipped to RUNNING.  Declare the death (with
        supervised recovery + fencing) and requeue the batch through the
        retry budget; the kick event buys the requeued nodes a cycle."""
        self._handle_worker_death(err)
        self._requeue_nodes(batch.nodes, count_retry=True)
        self._push(self.now, "kick", None)

    def _execute_real_hardened(
        self, batch: ScheduledBatch, inject_attempts: int,
    ) -> Optional[Tuple[float, float]]:
        """Run the stacked forward, retrying transient backend errors
        with capped backoff.  Returns (measured seconds, virtual backoff
        penalty) or None when the error outlives the retry budget."""
        self.backend.chaos_attempts = [0, inject_attempts]
        penalty = 0.0
        try:
            for attempt in range(1, self.retry.max_transient_retries + 2):
                try:
                    return self._execute_real(batch), penalty
                except TransientBackendError:
                    self.n_transient_retries += 1
                    penalty += self.retry.backoff(attempt)
                    if attempt > self.retry.max_transient_retries:
                        break
        finally:
            self.backend.chaos_attempts = None
        for eid in batch.executor_ids:
            self._note_executor_failure(self.by_id[eid])
        return None

    def _execute_real(self, batch: ScheduledBatch) -> float:
        """Executable plane: run the whole ScheduledBatch as ONE stacked
        forward per model (§5.1), splitting outputs back per request.
        Returns measured seconds.

        Nodes are grouped by concrete op class before stacking: a
        ``ScheduledBatch`` keys on ``model_id`` only, and two models may
        share weights under one ``model_id`` with different signatures
        (e.g. ``VAEEncode``/``VAEDecode``) — those execute as separate
        stacked forwards over the same cached components.
        """
        total = 0.0
        # sharded plane: a batch scheduled at k>1 executes on the submesh
        # formed by its executors' slots — the reservation made at
        # dispatch (all k executors occupied for the measured duration) is
        # what guarantees those slots stay exclusively ours until the
        # batch completes
        submesh = None
        if (batch.parallelism > 1 and isinstance(self.backend, ShardedBackend)
                and self.backend.enabled):
            submesh = self.backend.mesh_manager.submesh(batch.executor_ids)
        groups: Dict[type, List[RequestNode]] = {}
        for rn in batch.nodes:
            groups.setdefault(type(rn.node.op), []).append(rn)
        proc = self._proc
        multilora = batch.multilora
        trace_proc = proc and self._tele
        for rns in groups.values():
            lead = rns[0]
            op = lead.node.op
            is_segment = getattr(op, "is_segment", False)
            effective = lead.effective_patches
            patches = [p for p in op.patches if p.model_id in effective]
            if multilora:
                # mixed-adapter batch: patches travel per request as a
                # ``_patches`` kwarg so the backend can route the batch to
                # the grouped unfolded forward (adapter pool, no fold)
                patches = []
            batch_kwargs: List[Dict[str, Any]] = []
            out_keys: List[Dict[str, str]] = []
            for rn in rns:
                kwargs: Dict[str, Any] = {}
                if multilora:
                    eff = rn.effective_patches
                    kwargs["_patches"] = [
                        p for p in rn.node.op.patches if p.model_id in eff]
                for name, v in rn.node.inputs.items():
                    if isinstance(v, ValueRef):
                        key = rn.request.ref_key(v)
                        val = self.engine.value_of(key)
                        # proc plane: keyed inputs travel as StagedInput so
                        # the transport ships the payload only when the
                        # worker has not already staged the key
                        kwargs[name] = StagedInput(key, val) if proc else val
                    else:
                        kwargs[name] = v
                if is_segment:
                    # resume mid-schedule: the carried latent replaces the
                    # graph-input latent, and the chosen chunk bounds how
                    # many scan steps this dispatch runs
                    if rn.seg_state is not None:
                        if proc:
                            skey = (f"r{rn.request.rid}:n{rn.node.id}"
                                    f":seg:{rn.seg_done}")
                            kwargs["latents"] = StagedInput(skey, rn.seg_state)
                        else:
                            kwargs["latents"] = rn.seg_state
                    kwargs["_seg_start"] = rn.seg_done
                    kwargs["_seg_steps"] = batch.segment_steps
                if proc:
                    # where the worker stages this node's outputs: a chunk
                    # that finishes the segment (or any ordinary node)
                    # lands under its real ref keys; an intermediate chunk
                    # stages the carried latent under a synthetic step key
                    # so the NEXT chunk on the same worker sends a bare ref
                    ok: Dict[str, str] = {}
                    if is_segment:
                        total_steps = rn.segment_total
                        nxt = min(total_steps,
                                  rn.seg_done + max(1, batch.segment_steps))
                        if nxt >= total_steps:
                            for port, ref in rn.node.output_refs.items():
                                ok[port] = rn.request.ref_key(ref)
                        else:
                            ok["latents"] = (f"r{rn.request.rid}"
                                             f":n{rn.node.id}:seg:{nxt}")
                    else:
                        for port, ref in rn.node.output_refs.items():
                            ok[port] = rn.request.ref_key(ref)
                    out_keys.append(ok)
                batch_kwargs.append(kwargs)
            if submesh is not None:
                outs, load_dt, exec_dt = self.backend.execute_batch(
                    op, batch_kwargs, patches=patches, mesh=submesh)
            elif proc:
                if trace_proc:
                    # span context rides the exec RPC: the worker records
                    # stage/forward spans relative to RPC receipt and the
                    # backend rebases them onto this virtual timestamp.
                    # Offset by the groups already executed this dispatch
                    # (their virtual window is exactly their RPC wall) so
                    # successive groups' spans never overlap on the track
                    self.backend.trace_ctx = {
                        "ts": self.now + total,
                        "rids": sorted({rn.request.rid for rn in rns})}
                try:
                    outs, load_dt, exec_dt = self.backend.execute_batch(
                        op, batch_kwargs, patches=patches,
                        executor_id=batch.executor_ids[0], out_keys=out_keys)
                finally:
                    if trace_proc:
                        self.backend.trace_ctx = None
            else:
                outs, load_dt, exec_dt = self.backend.execute_batch(
                    op, batch_kwargs, patches=patches)
            for rn, out in zip(rns, outs):
                if is_segment:
                    # committed at batch_done (survives executor failure
                    # requeue without double-applying the chunk)
                    rn.seg_pending = out
                else:
                    rn.request.output_values[rn.uid] = out
            total += load_dt + exec_dt
        return total

    def _try_finish_running_node(self, rnode: RequestNode) -> None:
        """Own compute done; finish now or wait for deferred arrivals."""
        req = rnode.request
        latest = rnode.own_done_time or self.now
        unresolved = False
        for ref in rnode.node.deferred_input_refs():
            key = req.ref_key(ref)
            producer = req.nodes.get(ref.producer) if ref.producer is not None else None
            if producer is not None and producer.state != DONE:
                unresolved = True
                rnode.deferred_arrivals[key] = None
                continue
            arrival = rnode.deferred_arrivals.get(key)
            if arrival is None:
                lead = rnode.executor_ids[0] if rnode.executor_ids else None
                try:
                    cost = self.engine.fetch(key, lead) if (
                        lead is not None and self.engine.exists(key)) else 0.0
                except DataFetchError as err:
                    # the deferred value was lost in transit: requeue this
                    # node and lineage-recover the producer
                    self._requeue_nodes([rnode], count_retry=False)
                    self._recover_lost_fetch(err)
                    return
                arrival = self.now + cost
                rnode.deferred_arrivals[key] = arrival
            latest = max(latest, arrival)
        if unresolved:
            rnode.state = AWAITING
            return
        if latest > self.now:
            for eid in rnode.executor_ids:   # executor blocked on the fetch
                ex = self.by_id[eid]
                ex.busy_until = max(ex.busy_until, latest)
            self._push(latest, "node_late_complete", rnode)
        else:
            self._complete_node(rnode, self.now)

    def _complete_node(self, rnode: RequestNode, t: float) -> None:
        req = rnode.request
        if req.status != "inflight":
            return  # request was shed while this completion was in flight
        node = rnode.node
        rnode.state = DONE
        req.remaining -= 1
        req.remaining_work = max(0.0, req.remaining_work - rnode.infer_est)
        lead = rnode.executor_ids[0] if rnode.executor_ids else self._inline_placement(rnode)
        cost = node.op.cost()
        n_ports = max(1, len(node.output_refs))
        for port, ref in node.output_refs.items():
            key = req.ref_key(ref)
            value = None
            if self.backend is not None:
                out = req.output_values.get(rnode.uid)
                if out is None and node.attrs.get("inline"):
                    out = self._execute_inline(rnode)
                    req.output_values[rnode.uid] = out
                if isinstance(out, dict):
                    value = out.get(port)
            elif node.attrs.get("inline"):
                pass  # sim plane: inline ops carry no real payload
            nb = nbytes_of(value) if value is not None else cost.output_bytes / n_ports
            refcount = req.consumer_count.get(key, 0)
            if key in req.pinned_keys:
                refcount += 1_000_000
            if self.engine.exists(key):
                # a re-executed ancestor can complete while this output
                # (produced for a consumer on a lost executor) survived
                # elsewhere — values are immutable, so keep the live copy
                # rather than double-committing it
                continue
            self.engine.put(key, executor_id=lead, nbytes=int(nb), value=value,
                            producer_node=rnode.uid, refcount=max(1, refcount))
        # release consumed inputs (immutable, refcounted GC)
        for ref in node.all_input_refs():
            self.engine.release(req.ref_key(ref))
        # wake downstream nodes
        for consumer in req.graph.consumers.get(node.id, []):
            crn = req.nodes[consumer.id]
            is_eager_dep = any(
                r.producer == node.id for r in consumer.eager_input_refs()
            )
            if is_eager_dep and crn.state == PENDING:
                crn.pending_eager -= 1
                if crn.pending_eager == 0:
                    self._node_ready(crn)
            # resolve deferred futures on running/awaiting consumers
            for r in consumer.deferred_input_refs():
                if r.producer != node.id:
                    continue
                key = req.ref_key(r)
                if crn.state in (RUNNING, AWAITING):
                    lead_c = crn.executor_ids[0] if crn.executor_ids else None
                    try:
                        fetch = self.engine.fetch(key, lead_c) if (
                            lead_c is not None and self.engine.exists(key)) else 0.0
                    except DataFetchError as err:
                        self._requeue_nodes([crn], count_retry=False)
                        self._recover_lost_fetch(err)
                        continue
                    crn.deferred_arrivals[key] = t + fetch
                    if crn.state == AWAITING:
                        crn.state = RUNNING
                        self._try_finish_running_node(crn)
        # waking an inline consumer above completes it in place, and that
        # nested completion may already have finished the request
        if req.remaining == 0 and req.status == "inflight":
            self._finish_request(req, t)

    def _execute_inline(self, rnode: RequestNode) -> Any:
        req = rnode.request
        kwargs: Dict[str, Any] = {}
        for name, v in rnode.node.inputs.items():
            if isinstance(v, ValueRef):
                kwargs[name] = self.engine.value_of(req.ref_key(v))
            else:
                kwargs[name] = v
        return rnode.node.op.execute({}, **kwargs)

    def _inline_placement(self, rnode: RequestNode) -> Optional[int]:
        req = rnode.request
        for ref in rnode.node.all_input_refs():
            key = req.ref_key(ref)
            if self.engine.exists(key):
                placements = self.engine.get(key).placements
                if placements:
                    return next(iter(placements))
        return None

    def _finish_request(self, req: Request, t: float) -> None:
        req.completion = t
        req.status = "done"
        self.inflight.pop(req.rid, None)
        self.finished.append(req)
        if self._tele:
            # zero-duration marker slice on the requests track anchors
            # the flow finish (flow arrows bind to slices, not async
            # events), then the async request span closes
            self.tracer.span(
                f"complete r{req.rid}", t, 0.0, COORDINATOR_PID,
                "requests", cat="request", trace=req.rid,
                args={"latency": req.latency})
            self.tracer.flow(req.rid, t, COORDINATOR_PID, "requests",
                             end=True)
            self.tracer.end_request(
                req.rid, f"r{req.rid} {req.workflow_name}", t,
                status="done")
        # GC everything this request still holds (inputs + non-output temps
        # + replicated segment commits)
        leftovers = [f"r{req.rid}:in:{name}" for name in req.graph.input_ports]
        for n in req.graph.nodes:
            leftovers.extend(req.ref_key(ref) for ref in n.output_refs.values())
        leftovers.extend(rn.seg_commit[0] for rn in req.nodes.values()
                         if rn.seg_commit is not None)
        for key in leftovers:
            if self.engine.exists(key) and key not in req.pinned_keys:
                self._drop_key(key)

    # -------------------------------------------------------------- metrics
    def slo_attainment(self, include_rejected: bool = True) -> float:
        attained = sum(1 for r in self.finished if r.attained)
        total = len(self.finished) + len(self.shed) + (
            len(self.rejected) if include_rejected else 0)
        return attained / total if total else 0.0

    def mean_latency(self) -> float:
        lats = [r.latency for r in self.finished if r.latency is not None]
        return sum(lats) / len(lats) if lats else 0.0

    def p99_latency(self) -> float:
        from repro_torch.sim.metrics import quantile

        lats = sorted(r.latency for r in self.finished if r.latency is not None)
        if not lats:
            return 0.0
        return quantile(lats, 0.99)

    def total_busy_time(self) -> float:
        return sum(e.busy_time for e in self.executors)

    def scale_actions(self, kind: Optional[str] = None) -> List[ScaleAction]:
        if self.autoscaler is None:
            return []
        if kind is None:
            return list(self.autoscaler.actions)
        return [a for a in self.autoscaler.actions if a.kind == kind]
