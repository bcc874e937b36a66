"""Monolithic-serving baselines (§7.1 Baselines).

Whole workflows are the schedulable unit: every constituent model is
loaded/replicated together, no cross-workflow model sharing, no intra-
workflow parallelism (k=1), workflow-level admission control, FCFS.

* ``Diffusers``   — static deployment: each workflow statically bound to
  dedicated, preloaded GPUs.
* ``Diffusers-C`` — Clockwork-adapted swap-based serving: whole-workflow
  monoliths are swapped in/out of GPU memory on demand, one request at a
  time (predictability-first).
* ``Diffusers-S`` — Shepherd-adapted planning: swap-based with scored
  placement and whole-workflow batching — the strongest baseline.

All three consume the same :class:`~repro_torch.core.compiler.CompiledGraph` and
:class:`~repro_torch.core.profiles.ProfileStore` as LegoDiffusion, so every
latency number comes from the identical cost model; only the serving
granularity differs.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.core.compiler import CompiledGraph
from repro_torch.core.profiles import ProfileStore, node_infer_time
from repro_torch.sim.metrics import RequestRecord


@dataclasses.dataclass
class WorkflowSpec:
    """Workflow-granularity view of a compiled graph."""

    name: str
    serial_seconds_b1: float          # one request, executed serially
    per_item_seconds: Dict[int, float]  # batch -> per-batch duration
    footprint_bytes: float
    load_seconds: float
    max_batch: int

    @classmethod
    def from_graph(cls, graph: CompiledGraph, profiles: ProfileStore) -> "WorkflowSpec":
        model_ids: Dict[str, float] = {}
        serial = 0.0
        max_batch = 64
        for n in graph.nodes:
            if n.attrs.get("inline") or n.attrs.get("io_only"):
                continue
            p = profiles.profile_model(n.op)
            # segment nodes carry their schedule length on the node, not
            # the (model_id-shared) profile
            serial += node_infer_time(profiles, n)
            model_ids[n.op.model_id] = p.param_bytes
            max_batch = min(max_batch, p.max_batch)
            for patch in n.op.patches:
                pc = patch.cost()
                model_ids.setdefault(f"patch:{patch.model_id}", pc.param_bytes)
        footprint = sum(model_ids.values())
        per_item = {}
        for b in (1, 2, 4, 8, 16, 32, 64):
            if b > max_batch:
                break
            tot = 0.0
            for n in graph.nodes:
                if n.attrs.get("inline") or n.attrs.get("io_only"):
                    continue
                tot += node_infer_time(profiles, n, batch=b)
            per_item[b] = tot
        return cls(
            name=graph.name,
            serial_seconds_b1=serial,
            per_item_seconds=per_item,
            footprint_bytes=footprint,
            load_seconds=footprint / profiles.hw.host_load_bw + 0.02,
            max_batch=max_batch,
        )

    def duration(self, batch: int) -> float:
        batch = min(batch, self.max_batch)
        best = None
        for b, t in self.per_item_seconds.items():
            if b >= batch:
                best = t
                break
        return best if best is not None else max(self.per_item_seconds.values())


@dataclasses.dataclass
class _Gpu:
    gid: int
    resident: Optional[str] = None     # workflow name
    busy_until: float = 0.0
    dedicated_to: Optional[str] = None
    busy_time: float = 0.0
    loads: int = 0


@dataclasses.dataclass
class _QueuedRequest:
    arrival: float
    workflow: str
    deadline: Optional[float]
    record: RequestRecord


class MonolithicSystem:
    """Event-driven simulator for the three monolithic baselines."""

    def __init__(
        self,
        n_gpus: int,
        profiles: ProfileStore,
        specs: Dict[str, WorkflowSpec],
        mode: str = "diffusers-s",
        admission: bool = True,
    ) -> None:
        assert mode in ("diffusers", "diffusers-c", "diffusers-s")
        self.mode = mode
        self.profiles = profiles
        self.specs = specs
        self.admission_enabled = admission
        self.gpus = [_Gpu(i) for i in range(n_gpus)]
        if mode == "diffusers":
            names = sorted(specs)
            for i, g in enumerate(self.gpus):
                g.dedicated_to = names[i % len(names)]
                g.resident = g.dedicated_to       # statically preloaded
        self.queue: List[_QueuedRequest] = []
        self.records: List[RequestRecord] = []
        self.events: List[Tuple[float, int, str, object]] = []
        self._c = itertools.count()
        self.now = 0.0
        self.rejected = 0

    # ----------------------------------------------------------------- API
    def submit(self, arrival: float, workflow: str, slo_seconds: Optional[float]) -> None:
        rec = RequestRecord(
            arrival=arrival, workflow=workflow,
            deadline=None if slo_seconds is None else arrival + slo_seconds,
        )
        self.records.append(rec)
        heapq.heappush(self.events, (arrival, next(self._c), "arrival",
                                     _QueuedRequest(arrival, workflow, rec.deadline, rec)))

    def run(self) -> List[RequestRecord]:
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            self.now = max(self.now, t)
            if kind == "arrival":
                self._on_arrival(payload)
            self._dispatch()
        return self.records

    # ------------------------------------------------------------ internals
    def _backlog_work(self) -> float:
        return sum(self.specs[q.workflow].serial_seconds_b1 for q in self.queue)

    def _on_arrival(self, q: _QueuedRequest) -> None:
        if self.admission_enabled and q.deadline is not None:
            spec = self.specs[q.workflow]
            # NOTE: deliberately ignores cold-start swap cost — counting it
            # deadlocks never-admitted (hence never-warm) workflows into
            # permanent rejection; the estimator mirrors LegoDiffusion's
            # (which also excludes L_load)
            est = self._backlog_work() / max(1, len(self.gpus)) + spec.serial_seconds_b1
            if self.now + est > q.deadline:
                q.record.rejected = True
                self.rejected += 1
                return
        self.queue.append(q)

    def _eligible_gpus(self, workflow: str) -> List[_Gpu]:
        free = [g for g in self.gpus if g.busy_until <= self.now]
        if self.mode == "diffusers":
            return [g for g in free if g.dedicated_to == workflow]
        return free

    def _dispatch(self) -> None:
        progressed = True
        while progressed and self.queue:
            progressed = False
            self.queue.sort(key=lambda q: q.arrival)
            head = self.queue[0]
            gpus = self._eligible_gpus(head.workflow)
            if not gpus:
                # strict FCFS head-of-line blocking: monolithic serving has
                # no way to skip ahead (part of L1's inefficiency)
                break
            spec = self.specs[head.workflow]
            if self.mode == "diffusers-c":
                batch = [head]                    # one request at a time
            else:
                batch = [q for q in self.queue if q.workflow == head.workflow]
                batch = batch[: spec.max_batch]
            # placement
            warm = [g for g in gpus if g.resident == head.workflow]
            if self.mode == "diffusers-s":
                gpu = warm[0] if warm else min(gpus, key=lambda g: g.gid)
            else:
                gpu = warm[0] if warm else gpus[0]
            load = 0.0
            if gpu.resident != head.workflow:
                load = spec.load_seconds          # swap the ENTIRE workflow
                gpu.resident = head.workflow
                gpu.loads += 1
            dur = load + spec.duration(len(batch))
            gpu.busy_until = self.now + dur
            gpu.busy_time += dur
            done = self.now + dur
            for q in batch:
                q.record.completion = done
                self.queue.remove(q)
            heapq.heappush(self.events, (done, next(self._c), "free", None))
            progressed = True

    # -------------------------------------------------------------- metrics
    def slo_attainment(self) -> float:
        from repro_torch.sim.metrics import slo_attainment
        return slo_attainment(self.records)

    def total_loads(self) -> int:
        return sum(g.loads for g in self.gpus)
