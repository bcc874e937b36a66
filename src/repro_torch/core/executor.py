"""Executors — one device each, with a model cache (§4, Fig. 5).

An executor owns one accelerator.  It tracks which models are resident in
device memory (the coordinator mirrors this in its *model state table*),
evicts idle models LRU-style under memory pressure, and carries
per-request patch state (which LoRA is currently folded into a resident
base model).

Two backends share this class:

* **simulated** (default) — execution is a duration from the profiles;
* **local** (:class:`LocalBackend`) — `load()`/`execute()` actually run on
  one torch device (the CUDA card unless the caller asks for the CPU),
  used by the executable examples and the chip smoke run;
* **sharded** (:class:`ShardedBackend`) — a batch scheduled at
  parallelism k > 1 runs as one sharded forward over the k device slots
  of its executors (:mod:`repro_torch.core.mesh`).
"""

from __future__ import annotations

import os
import time as _time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.mesh import MeshManager, Submesh, sharded_exec_enabled
from repro_torch.core.model import Model
from repro_torch.core.profiles import ProfileStore
from repro_torch.core.telemetry import FoldCacheEviction, default_registry
from repro_torch.weights import to_device

# Lifecycle states (autoscaler-managed; a fixed fleet stays SERVING forever):
#
#   RESERVE -> PROVISIONING -> WARMING -> SERVING -> DRAINING -> RESERVE
#
# RESERVE       cold standby — no device state, never scheduled;
# PROVISIONING  acquired for a model, waiting for the warm-up to start;
# WARMING       streaming the target model's weights host->HBM;
# SERVING       schedulable (the only state the Scheduler scores);
# DRAINING      finishing its current batch, then retires/unassigns;
# QUARANTINE    flapping (too many failure marks in a window) — drained,
#               invisible to placement, re-provisioned cold after a
#               cooldown (chaos-plane hardening).
RESERVE = "reserve"
PROVISIONING = "provisioning"
WARMING = "warming"
SERVING = "serving"
DRAINING = "draining"
QUARANTINE = "quarantine"


class OutOfMemory(RuntimeError):
    pass


class ForwardLog(deque):
    """Bounded dispatch-accounting log: ``(model_id, batch_size)`` per
    real forward.  A long-running serving process must not grow this
    without bound, so the log is a ring of the most recent
    ``REPRO_FORWARD_LOG_CAP`` entries (default 4096); overwritten
    entries are counted in ``dropped`` (scraped as
    ``backend_forward_log_dropped``) so consumers can tell a truncated
    history from a short one."""

    def __init__(self, cap: Optional[int] = None) -> None:
        if cap is None:
            cap = int(os.environ.get("REPRO_FORWARD_LOG_CAP", "4096"))
        super().__init__(maxlen=max(1, cap))
        self.dropped = 0

    def append(self, item: Any) -> None:
        if len(self) == self.maxlen:
            self.dropped += 1
        super().append(item)

    def extend(self, items: Any) -> None:
        for item in items:
            self.append(item)


class Executor:
    def __init__(
        self,
        executor_id: int,
        profiles: ProfileStore,
        memory_capacity: Optional[float] = None,
        pod: int = 0,
        state: str = SERVING,
    ) -> None:
        self.id = executor_id
        self.profiles = profiles
        self.capacity = memory_capacity or profiles.hw.hbm_capacity
        self.pod = pod
        # model_id -> bytes, in LRU order (most-recent last)
        self.loaded: "OrderedDict[str, float]" = OrderedDict()
        # model_id -> list of patch model_ids currently folded in
        self.patch_state: Dict[str, List[str]] = {}
        self.busy_until: float = 0.0
        self.alive: bool = True
        # lifecycle (autoscaler)
        self.state: str = state
        self.reserve_born: bool = state == RESERVE
        self.warming_model: Optional[str] = None
        self.assigned_models: set = set()   # models this executor was scaled for
        # accounting
        self.busy_time: float = 0.0
        self.models_loaded_count: int = 0
        self.bytes_loaded: float = 0.0
        self.scale_events: int = 0
        # failure/chaos accounting: timestamps of recent failure marks
        # (timeouts, transient exhaustion, crashes) for the flapping-
        # executor quarantine window
        self.failure_times: Deque[float] = deque()
        self.n_failures: int = 0
        self.n_quarantines: int = 0
        self.n_revives: int = 0
        # process plane (ProcBackend): pid of the worker process backing
        # this executor, and its fencing epoch — bumped on every declared
        # death so a zombie incarnation's late replies are rejectable
        self.worker_pid: Optional[int] = None
        self.epoch: int = 0

    # ------------------------------------------------------------- memory
    @property
    def used_memory(self) -> float:
        return sum(self.loaded.values())

    def has_model(self, model_id: str) -> bool:
        return model_id in self.loaded

    def touch(self, model_id: str) -> None:
        if model_id in self.loaded:
            self.loaded.move_to_end(model_id)

    def can_fit(self, nbytes: float) -> bool:
        return self.used_memory + nbytes <= self.capacity

    def ensure_capacity(self, nbytes: float, protected: Optional[set] = None) -> List[str]:
        """Evict LRU models until ``nbytes`` fits; returns evicted ids."""
        protected = protected or set()
        evicted: List[str] = []
        while self.used_memory + nbytes > self.capacity:
            victim = None
            for mid in self.loaded:  # LRU first
                if mid not in protected:
                    victim = mid
                    break
            if victim is None:
                raise OutOfMemory(
                    f"executor {self.id}: cannot fit {nbytes/2**30:.2f} GiB "
                    f"(used {self.used_memory/2**30:.2f}/{self.capacity/2**30:.2f} GiB)"
                )
            del self.loaded[victim]
            self.patch_state.pop(victim, None)
            evicted.append(victim)
        return evicted

    def mark_loaded(self, model_id: str, nbytes: float) -> None:
        self.ensure_capacity(nbytes, protected=set(self.loaded))
        self.loaded[model_id] = nbytes
        self.loaded.move_to_end(model_id)
        self.models_loaded_count += 1
        self.bytes_loaded += nbytes

    # ------------------------------------------------------------ patches
    def patches_on(self, model_id: str) -> List[str]:
        return self.patch_state.get(model_id, [])

    def set_patches(self, model_id: str, patch_ids: List[str]) -> None:
        self.patch_state[model_id] = list(patch_ids)

    # ----------------------------------------------------------- lifecycle
    @property
    def is_serving(self) -> bool:
        return self.alive and self.state == SERVING

    def begin_provisioning(self, model_id: str) -> None:
        assert self.state in (RESERVE, SERVING), self.state
        self.state = PROVISIONING
        self.warming_model = model_id

    def begin_warming(self) -> None:
        assert self.state == PROVISIONING, self.state
        self.state = WARMING

    def finish_warming(self, nbytes: float) -> None:
        """Warm-pool handoff complete: weights resident, open for dispatch."""
        assert self.state == WARMING and self.warming_model is not None
        self.mark_loaded(self.warming_model, nbytes)
        self.assigned_models.add(self.warming_model)
        self.warming_model = None
        self.state = SERVING
        self.scale_events += 1

    def begin_draining(self, model_id: str) -> None:
        assert self.state == SERVING, self.state
        self.state = DRAINING
        self.warming_model = model_id    # the model being retired

    def finish_draining(self) -> None:
        """Current batch done: evict the retired model; reserve-born
        executors give the device back entirely."""
        assert self.state == DRAINING
        mid = self.warming_model
        self.warming_model = None
        if mid is not None:
            self.loaded.pop(mid, None)
            self.patch_state.pop(mid, None)
            self.assigned_models.discard(mid)
        if self.reserve_born:
            self.loaded.clear()
            self.patch_state.clear()
            self.assigned_models.clear()
            self.state = RESERVE
        else:
            self.state = SERVING
        self.scale_events += 1

    # ------------------------------------------------------------ timeline
    def is_free(self, now: float) -> bool:
        return self.is_serving and self.busy_until <= now

    def occupy(self, now: float, duration: float) -> float:
        start = max(now, self.busy_until)
        self.busy_until = start + duration
        self.busy_time += duration
        return self.busy_until

    def cancel(self, now: float) -> float:
        """Cancel a runaway (hung/timed-out) forward: free the executor
        now and give the unspent seconds back to the busy accounting.
        Returns the reclaimed seconds."""
        reclaimed = max(0.0, self.busy_until - now)
        self.busy_time = max(0.0, self.busy_time - reclaimed)
        self.busy_until = min(self.busy_until, now)
        return reclaimed

    def fail(self) -> None:
        self.alive = False
        self.loaded.clear()
        self.patch_state.clear()
        self.assigned_models.clear()
        self.warming_model = None

    def revive(self, now: float) -> None:
        """Process restart after a crash: back to service with cold
        caches (``fail()`` already dropped all device state)."""
        self.alive = True
        self.state = SERVING
        self.busy_until = now
        self.n_revives += 1

    # ----------------------------------------------------------- quarantine
    def note_failure(self, now: float, window: float) -> int:
        """Record one failure mark (timeout / transient exhaustion /
        crash); returns the number of marks inside ``window``."""
        self.n_failures += 1
        self.failure_times.append(now)
        horizon = now - window
        while self.failure_times and self.failure_times[0] < horizon:
            self.failure_times.popleft()
        return len(self.failure_times)

    def begin_quarantine(self) -> None:
        """Drain a flapping executor: drop residents, leave placement."""
        self.state = QUARANTINE
        self.loaded.clear()
        self.patch_state.clear()
        self.assigned_models.clear()
        self.warming_model = None
        self.n_quarantines += 1
        self.scale_events += 1

    def release_quarantine(self) -> None:
        """Cooldown over: re-provision cold.  Reserve-born executors give
        the device back to the pool; fixed-fleet ones return to service
        (empty caches — the warm-pool/LRU machinery refills them)."""
        assert self.state == QUARANTINE, self.state
        self.failure_times.clear()
        self.state = RESERVE if self.reserve_born else SERVING
        self.scale_events += 1

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"<Executor {self.id} pod={self.pod} {self.state} "
            f"models={list(self.loaded)} busy_until={self.busy_until:.3f}>"
        )


def _tree_bytes(tree: Any) -> float:
    """Device bytes held by the tensor leaves of a components tree of
    dicts, lists and tuples (callables and plain python leaves count as
    zero)."""
    if isinstance(tree, torch.Tensor):
        return float(tree.numel() * tree.element_size())
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0.0


class AdapterPool:
    """Bounded LRU of DECODED adapter components, keyed by patch model_id.

    The unfolded multi-LoRA serving mode applies adapters per row against
    the shared base params, so the device state an adapter needs is just
    its decoded A/B factors — this pool holds them with byte accounting
    and LRU eviction, replacing the unbounded per-placement fold cache as
    the steady-state residency for multi-tenant adapter traffic.
    """

    def __init__(self, capacity_bytes: Optional[float] = None,
                 device: Optional[torch.device] = None) -> None:
        self.device = device
        if capacity_bytes is None:
            capacity_bytes = float(os.environ.get(
                "REPRO_ADAPTER_POOL_BYTES", 256 * 2**20))
        self.capacity = float(capacity_bytes)
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._bytes: Dict[str, float] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def resident_bytes(self) -> float:
        return sum(self._bytes.values())

    def __contains__(self, patch_id: str) -> bool:
        return patch_id in self._entries

    def ids(self) -> List[str]:
        return list(self._entries)

    def _insert(self, patch_id: str, comps: Dict[str, Any]) -> None:
        self._entries[patch_id] = comps
        self._entries.move_to_end(patch_id)
        self._bytes[patch_id] = _tree_bytes(comps)
        while self.resident_bytes > self.capacity and len(self._entries) > 1:
            victim, _ = self._entries.popitem(last=False)
            self._bytes.pop(victim, None)
            self.evictions += 1

    def seed(self, patch_id: str, comps: Dict[str, Any]) -> None:
        """Insert pre-decoded components (proc-plane staging path) on the
        pool's device: a worker decodes them off the wire as CPU
        tensors."""
        if patch_id in self._entries:
            self._entries.move_to_end(patch_id)
            return
        if self.device is not None:
            comps = to_device(comps, self.device)
        self._insert(patch_id, comps)

    def get(self, patch: Model) -> Tuple[Dict[str, Any], float]:
        """Decoded components for ``patch`` (load on miss).  Returns
        (components, measured load seconds — 0 on a hit)."""
        pid = patch.model_id
        if pid in self._entries:
            self._entries.move_to_end(pid)
            self.hits += 1
            return self._entries[pid], 0.0
        self.misses += 1
        t0 = _time.perf_counter()
        comps = patch.load(device=self.device)
        dt = _time.perf_counter() - t0
        self._insert(pid, comps)
        return comps, dt

    def drop(self, patch_id: str) -> None:
        self._entries.pop(patch_id, None)
        self._bytes.pop(patch_id, None)


class LocalBackend:
    """Really-execute backend: loads params and runs ``Model.execute`` /
    ``Model.execute_batch`` on one torch device.  Used by the executable
    plane.

    ``device`` defaults to ``"cuda"``: the backend runs on the card unless
    the caller asks for the CPU (``device="cpu"``, as the tests do).  A
    CUDA device with no card available raises here — the backend never
    carries on on the CPU in its place.

    Caches three levels of device state:

    * base components per ``model_id`` (includes LoRA adapters — an
      adapter's ``load()`` runs once, not once per denoising step);
    * LoRA-folded parameter sets per ``(model_id, patch_ids)`` placement —
      a TRUE LRU under ``folded_budget_bytes`` (evictions append
      ``("evict:<model_id>", 0)`` markers to ``forward_log``), so
      per-placement folds can no longer grow without bound;
    * an :class:`AdapterPool` of decoded A/B factors backing the unfolded
      grouped multi-LoRA route (mixed-adapter batches never fold).
    """

    # proc plane span context (set by the coordinator around an exec RPC
    # when tracing is on; see repro_torch.core.supervisor.ProcBackend)
    trace_ctx: Optional[Dict[str, Any]] = None

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 folded_budget_bytes: Optional[float] = None,
                 adapter_pool_bytes: Optional[float] = None) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"LocalBackend(device={str(self.device)!r}): no CUDA device "
                f"is available; pass device='cpu' to run on the CPU")
        self._components: Dict[str, Dict[str, Any]] = {}
        # (model_id, (patch_id, ...)) -> patched components, LRU order
        self._folded: "OrderedDict[Tuple[str, Tuple[str, ...]], Dict[str, Any]]" = OrderedDict()
        self._folded_bytes: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        if folded_budget_bytes is None:
            folded_budget_bytes = float(os.environ.get(
                "REPRO_FOLD_CACHE_BYTES", 4 * 2**30))
        self.folded_budget_bytes = float(folded_budget_bytes)
        self.folded_evictions = 0
        self.adapter_pool = AdapterPool(adapter_pool_bytes, self.device)
        self.multilora_forwards = 0
        # (model_id, batch_size) per real forward — dispatch accounting
        # (bounded ring; see ForwardLog)
        self.forward_log: ForwardLog = ForwardLog()
        # cumulative measured device seconds (load folds + executes):
        # lets callers separate control-plane overhead from real compute
        self.exec_seconds: float = 0.0
        # chaos-plane hook: [attempts_so_far, attempts_that_must_fail] —
        # set by the coordinator per dispatch when its FaultPlane injects
        # a transient backend error; the error is raised HERE, before any
        # device work, so the retry path exercises the real call boundary
        self.chaos_attempts: Optional[List[int]] = None
        self.n_injected_errors: int = 0

    def _maybe_inject_fault(self) -> None:
        if self.chaos_attempts is None:
            return
        self.chaos_attempts[0] += 1
        if self.chaos_attempts[0] <= self.chaos_attempts[1]:
            from repro_torch.core.faults import TransientBackendError

            self.n_injected_errors += 1
            raise TransientBackendError(
                f"injected transient backend error "
                f"(attempt {self.chaos_attempts[0]})")
        # decision consumed: nested delegations must not re-draw for the
        # same logical call
        self.chaos_attempts = None

    def ensure_loaded(self, model: Model) -> Tuple[Dict[str, Any], float]:
        """Returns (components, measured load seconds — 0 if cached)."""
        if model.model_id in self._components:
            return self._components[model.model_id], 0.0
        t0 = _time.perf_counter()
        comps = model.load(device=self.device)
        dt = _time.perf_counter() - t0
        self._components[model.model_id] = comps
        return comps, dt

    def components_for(
        self, model: Model, patches: Sequence[Model] = ()
    ) -> Tuple[Dict[str, Any], float]:
        """Components with ``patches`` folded in; folds are cached per
        ``(model_id, patch_ids)``.  Returns (components, load seconds)."""
        comps, load_dt = self.ensure_loaded(model)
        patches = list(patches or [])
        if not patches:
            return comps, load_dt
        key = (model.model_id, tuple(p.model_id for p in patches))
        if key in self._folded:
            self._folded.move_to_end(key)
            return self._folded[key], load_dt
        patch_comps = []
        for p in patches:
            pc, pdt = self.ensure_loaded(p)
            load_dt += pdt
            patch_comps.append(pc)
        t0 = _time.perf_counter()
        folded = model.fold_patches(comps, patches, patch_comps)
        load_dt += _time.perf_counter() - t0
        self._folded[key] = folded
        self._folded_bytes[key] = _tree_bytes(folded)
        while (sum(self._folded_bytes.values()) > self.folded_budget_bytes
               and len(self._folded) > 1):
            victim, _ = self._folded.popitem(last=False)
            self._folded_bytes.pop(victim, None)
            self.folded_evictions += 1
            # typed event on the telemetry registry is the primary
            # eviction signal; the stringly forward_log marker stays as
            # a compat shim for pre-telemetry consumers
            default_registry().emit(FoldCacheEviction(
                model_id=victim[0], patch_ids=victim[1],
                resident_bytes=sum(self._folded_bytes.values())))
            self.forward_log.append((f"evict:{victim[0]}", 0))
        return folded, load_dt

    @property
    def folded_resident_bytes(self) -> float:
        return sum(self._folded_bytes.values())

    @property
    def forward_log_dropped(self) -> int:
        """Entries the bounded ``forward_log`` ring has overwritten."""
        return getattr(self.forward_log, "dropped", 0)

    def unload(self, model_id: str) -> None:
        self._components.pop(model_id, None)
        self.adapter_pool.drop(model_id)
        for k in [k for k in self._folded
                  if k[0] == model_id or model_id in k[1]]:
            del self._folded[k]
            self._folded_bytes.pop(k, None)

    def _block(self, out: Any) -> None:
        """Wait for async-dispatched device work: the measured duration
        feeds the coordinator's event timeline, so it must cover the real
        compute, not just the host-side launch.  A fault raised by the
        device work surfaces here."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def execute(self, model: Model, **kwargs: Any) -> Tuple[Dict[str, Any], float]:
        self._maybe_inject_fault()
        patches = kwargs.pop("_patches", None) or []
        comps, load_dt = self.components_for(model, patches)
        t0 = _time.perf_counter()
        out = model.execute(comps, **kwargs)
        self._block(out)
        dt = _time.perf_counter() - t0
        self.forward_log.append((model.model_id, 1))
        # exec_seconds covers load folds + executes (same contract as
        # execute_batch); the returned dt stays forward-only
        self.exec_seconds += load_dt + dt
        return out, dt

    @staticmethod
    def _lift_patches(
        batch_kwargs: List[Dict[str, Any]], patches: Sequence[Model]
    ) -> Tuple[Sequence[Model], List[Dict[str, Any]], bool]:
        """Normalize patch routing for a stacked forward.

        Patches may arrive either via ``patches`` (the serving runtime) or
        as a uniform per-request ``_patches`` kwarg (direct callers); a
        mixed per-request set is passed through so the model's own
        fallback can fold per item.  Returns (patches, cleaned kwargs,
        uniform?)."""
        per_item = [kw.get("_patches") or [] for kw in batch_kwargs]
        ids = [tuple(p.model_id for p in ps) for ps in per_item]
        uniform = all(i == ids[0] for i in ids[1:])
        if uniform:
            if not list(patches or []) and per_item[0]:
                patches = per_item[0]
            clean = [{k: v for k, v in kw.items() if k != "_patches"}
                     for kw in batch_kwargs]
        else:
            clean = [dict(kw) for kw in batch_kwargs]
        return patches, clean, uniform

    def execute_batch(
        self,
        model: Model,
        batch_kwargs: List[Dict[str, Any]],
        patches: Sequence[Model] = (),
    ) -> Tuple[List[Dict[str, Any]], float, float]:
        """One stacked forward for a whole ScheduledBatch.  Returns
        (per-request outputs, load seconds, execute seconds)."""
        self._maybe_inject_fault()
        patches, clean, uniform = self._lift_patches(batch_kwargs, patches)
        if not uniform and getattr(model, "supports_multilora", False):
            res = self._execute_batch_multilora(model, batch_kwargs)
            if res is not None:
                return res
        comps, load_dt = self.components_for(model, patches)
        model._batch_was_stacked = True
        t0 = _time.perf_counter()
        outs = model.execute_batch(comps, clean)
        self._block(outs)
        exec_dt = _time.perf_counter() - t0
        if model._batch_was_stacked:
            self.forward_log.append((model.model_id, len(batch_kwargs)))
        else:   # model fell back to per-request execution: log what ran
            self.forward_log.extend(
                (model.model_id, 1) for _ in batch_kwargs)
        self.exec_seconds += load_dt + exec_dt
        return outs, load_dt, exec_dt

    def _execute_batch_multilora(
        self, model: Model, batch_kwargs: List[Dict[str, Any]]
    ) -> Optional[Tuple[List[Dict[str, Any]], float, float]]:
        """Unfolded grouped route for a batch MIXING adapters: resolve each
        request's patch through the adapter pool and hand the batch (with
        its per-request ``_patches``) to ``execute_batch_multilora``.  The
        base components stay pristine — no fold, no patch-state mutation.
        Returns None when the model declines (the caller then falls back
        to the per-request fold path)."""
        comps, load_dt = self.ensure_loaded(model)
        adapters: Dict[str, Dict[str, Any]] = {}
        for kw in batch_kwargs:
            for p in kw.get("_patches") or []:
                if p.model_id not in adapters:
                    pc, pdt = self.adapter_pool.get(p)
                    load_dt += pdt
                    adapters[p.model_id] = pc
        t0 = _time.perf_counter()
        outs = model.execute_batch_multilora(comps, batch_kwargs, adapters)
        if outs is None:
            return None
        self._block(outs)
        exec_dt = _time.perf_counter() - t0
        self.multilora_forwards += 1
        self.forward_log.append((model.model_id, len(batch_kwargs)))
        self.exec_seconds += load_dt + exec_dt
        return outs, load_dt, exec_dt


class ShardedBackend(LocalBackend):
    """Multi-slot backend: materializes a :class:`ScheduledBatch`'s
    parallelism degree ``k`` as a real sharded forward over a k-slot
    :class:`~repro_torch.core.mesh.Submesh`.

    The coordinator passes the submesh assembled from the batch's
    executors; this backend replicates the (LoRA-folded) components onto
    its slots, one tree per slot cached per ``(model_id, patch_ids,
    slots)`` (a slot on the home card aliases the home tree: four slots of
    one card hold one copy of the weights), and hands the stacked batch to
    :meth:`Model.execute_batch_sharded`.  Models that decline (indivisible
    shapes, no sharded path) fall back to the inherited single-device
    stacked forward, so a one-slot manager or ``REPRO_SHARDED_EXEC=0``
    behaves exactly like :class:`LocalBackend`; ``shard_log`` records
    every forward that did shard.

    The home device, where the single-device path runs and where sharded
    outputs are gathered back (the coordinator's data plane is one
    device), is the manager's first slot.  ``MeshManager()`` with no
    devices takes every CUDA card and raises where there is none.
    """

    def __init__(self, mesh_manager: Optional[MeshManager] = None,
                 folded_budget_bytes: Optional[float] = None,
                 adapter_pool_bytes: Optional[float] = None) -> None:
        mesh_manager = mesh_manager or MeshManager()
        super().__init__(mesh_manager.devices[0], folded_budget_bytes,
                         adapter_pool_bytes)
        self.mesh_manager = mesh_manager
        self.enabled = (sharded_exec_enabled()
                        and mesh_manager.n_devices > 1)
        # (model_id, patch_ids, slots) -> one components tree per slot
        self._replicated: Dict[Tuple, List[Dict[str, Any]]] = {}
        # (model_id, batch_size, k, slots) per sharded forward
        self.shard_log: List[Tuple[str, int, int, Tuple[int, ...]]] = []

    # ------------------------------------------------------------ placement
    def replicated_components(
        self, model: Model, patches: Sequence[Model], mesh: Submesh
    ) -> Tuple[List[Dict[str, Any]], float]:
        """The components (patches folded in) on every slot of ``mesh``,
        cached per placement.  Returns (one tree per slot, measured load
        seconds)."""
        comps, load_dt = self.components_for(model, patches)
        key = (model.model_id, tuple(p.model_id for p in patches), mesh.slots)
        if key in self._replicated:
            return self._replicated[key], load_dt
        t0 = _time.perf_counter()
        out = mesh.replicate(comps)
        self._block_mesh(mesh)
        load_dt += _time.perf_counter() - t0
        self._replicated[key] = out
        return out, load_dt

    def unload(self, model_id: str) -> None:
        super().unload(model_id)
        self._replicated = {
            k: v for k, v in self._replicated.items()
            if k[0] != model_id and model_id not in k[1]
        }

    def _block_mesh(self, mesh: Submesh) -> None:
        """Wait for every card of the submesh and the home card (see
        ``_block``)."""
        for d in {d for d in (*mesh.devices, self.device) if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    # ------------------------------------------------------------ execution
    def execute_batch(
        self,
        model: Model,
        batch_kwargs: List[Dict[str, Any]],
        patches: Sequence[Model] = (),
        mesh: Optional[Submesh] = None,
    ) -> Tuple[List[Dict[str, Any]], float, float]:
        """Sharded stacked forward when ``mesh`` spans more than one slot,
        else the inherited single-device path."""
        self._maybe_inject_fault()
        if (mesh is None or not self.enabled
                or getattr(mesh, "size", 1) <= 1):
            return super().execute_batch(model, batch_kwargs, patches)
        lifted, clean, uniform = self._lift_patches(batch_kwargs, patches)
        if not uniform:
            # mixed per-request patch sets cannot share replicated params
            return super().execute_batch(model, batch_kwargs, patches)
        replicas, load_dt = self.replicated_components(model, lifted, mesh)
        t0 = _time.perf_counter()
        outs = model.execute_batch_sharded(replicas, clean, mesh)
        if outs is None:       # model declined: single-device fallback
            return super().execute_batch(model, batch_kwargs, patches)
        outs = [{k: (v.to(self.device) if isinstance(v, torch.Tensor) else v)
                 for k, v in out.items()} for out in outs]
        self._block_mesh(mesh)
        exec_dt = _time.perf_counter() - t0
        self.forward_log.append((model.model_id, len(batch_kwargs)))
        self.shard_log.append((model.model_id, len(batch_kwargs),
                               mesh.size, mesh.slots))
        self.exec_seconds += load_dt + exec_dt
        return outs, load_dt, exec_dt
