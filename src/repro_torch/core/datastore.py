"""Distributed data engine (§4.3.2).

Per-executor data stores with coordinator-tracked placement metadata.  The
paper builds this on NVSHMEM one-sided GPU transfers; on TPU there is no
one-sided RDMA analogue, so the engine is an explicit object store whose
transfer costs are modeled with ICI/DCN bandwidth (see DESIGN.md §3).  In
the executable plane the store holds real torch tensors; in the simulation
plane only byte counts move.

Key properties carried over from the paper:

* tensors are **immutable**: produced once, consumed, never updated — no
  consistency protocol needed;
* **metadata is tiny** (key + nbytes + placement) and piggybacks on
  node-completion notifications;
* values are **reference-counted** and reclaimed as soon as no downstream
  consumer remains;
* **lineage** (producer node id) supports recovery by re-execution when an
  executor fails.

**Serialized mode** (process-isolated plane): with ``serialized = True``
every ``put`` immediately encodes the value to a portable byte payload
and *drops the live object*; ``value_of`` decodes on demand.  Every
value the coordinator consumes or re-ships has therefore provably
round-tripped through bytes — placement is no longer a reference copy.
The engine additionally tracks a bounded per-executor **staging view**
(which keys each worker process holds in its local LRU), so repeat
dispatches send a bare key instead of re-shipping the tensor, and an
executor's death invalidates its whole view at once.
"""

from __future__ import annotations

import dataclasses
import time as _time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple


@dataclasses.dataclass
class StoredValue:
    key: str
    nbytes: int
    placements: Set[int]                 # executor ids holding a copy
    producer_node: Optional[str] = None  # lineage (request-scoped node uid)
    refcount: int = 0
    value: Any = None                    # real payload (executable plane)
    payload: Optional[bytes] = None      # serialized form (proc plane)


class FetchFuture:
    """Resolution handle for a *deferred* input (§4.3.2).

    A deferred input is a fetch function invoked at the point of
    consumption: returns immediately if the data is available, or blocks
    (in simulation: completes the consuming node later) until it arrives.
    """

    def __init__(self, key: str) -> None:
        self.key = key
        self.ready_time: Optional[float] = None
        self.value: Any = None

    @property
    def is_ready(self) -> bool:
        return self.ready_time is not None

    def resolve(self, time: float, value: Any = None) -> None:
        self.ready_time = time
        self.value = value


class DataEngine:
    """Coordinator-side view of all executor-local data stores."""

    def __init__(self, profiles: Any, pod_of: Optional[Dict[int, int]] = None) -> None:
        self.profiles = profiles
        self._store: Dict[str, StoredValue] = {}
        self.pod_of = pod_of or {}
        self.bytes_transferred: float = 0.0
        self.num_transfers: int = 0
        self.num_local_hits: int = 0
        # chaos plane (both set by the Coordinator when chaos is on):
        # a FaultPlane that may lose transfers in flight, and the retry
        # budget before a fetch is declared unrecoverable
        self.faults: Any = None
        self.max_fetch_retries: int = 3
        # hardening/invariant accounting
        self.fetch_retries: int = 0     # lost transfers that were retried
        self.failed_fetches: int = 0    # fetches lost past the budget
        self.duplicate_puts: int = 0    # puts over a LIVE key (dup commit)
        self.min_refcount_seen: int = 0  # most negative refcount observed
        # first-touch fetch order: fault draws hash this index instead of
        # the raw key, so replay is exact even when key strings embed
        # process-global node ids
        self._fetch_sites: Dict[str, int] = {}
        # serialized mode (process plane): values live as byte payloads
        self.serialized = False
        self.ser_seconds = 0.0          # wall spent encoding/decoding
        self.serialized_bytes = 0       # total payload bytes produced
        self.n_encodes = 0
        self.n_decodes = 0
        # per-executor staging views (insertion-ordered for LRU parity
        # with the worker-side store)
        self.staged: Dict[int, "OrderedDict[str, None]"] = {}
        self.staging_capacity = 512
        self.stage_evictions = 0

    # --------------------------------------------------------------- puts
    def put(
        self,
        key: str,
        executor_id: Optional[int],
        nbytes: int,
        value: Any = None,
        producer_node: Optional[str] = None,
        refcount: int = 0,
        replicate_to: Optional[int] = None,
    ) -> StoredValue:
        """Store a value.  ``replicate_to`` places a second synchronous
        copy (replicate-on-commit: survives a single executor loss, so
        recovery replays a chunk instead of a whole lineage chain)."""
        if key in self._store:
            # immutable-value contract: a live key is never re-committed
            self.duplicate_puts += 1
        placements = {executor_id} if executor_id is not None else set()
        if replicate_to is not None and replicate_to != executor_id:
            placements.add(replicate_to)
            self.bytes_transferred += int(nbytes)
            self.num_transfers += 1
        sv = StoredValue(
            key=key,
            nbytes=int(nbytes),
            placements=placements,
            producer_node=producer_node,
            refcount=refcount,
            value=value,
        )
        if self.serialized and value is not None:
            # serialized put: the live object is dropped — anything read
            # back provably round-tripped through bytes, like a value
            # crossing a process boundary does
            from repro_torch.core.transport import encode_value

            t0 = _time.perf_counter()
            sv.payload = encode_value(value)
            self.ser_seconds += _time.perf_counter() - t0
            self.serialized_bytes += len(sv.payload)
            self.n_encodes += 1
            sv.value = None
        self._store[key] = sv
        return sv

    def exists(self, key: str) -> bool:
        return key in self._store

    def get(self, key: str) -> StoredValue:
        return self._store[key]

    def value_of(self, key: str) -> Any:
        sv = self._store[key]
        if sv.value is None and sv.payload is not None:
            from repro_torch.core.transport import decode_value

            t0 = _time.perf_counter()
            sv.value = decode_value(sv.payload)
            self.ser_seconds += _time.perf_counter() - t0
            self.n_decodes += 1
        return sv.value

    def payload_for(self, key: str) -> Optional[bytes]:
        """Canonical serialized form of ``key`` (None when the value
        never went through a serialized put) — reused by the transport
        so a tensor is encoded once, not once per ship."""
        sv = self._store.get(key)
        return sv.payload if sv is not None else None

    # ------------------------------------------------------------- staging
    def stage_mark(self, executor_id: int, key: str) -> None:
        """Record that ``executor_id``'s worker process now holds ``key``
        in its local staging store (shipped to it, or produced by it)."""
        view = self.staged.setdefault(executor_id, OrderedDict())
        view[key] = None
        view.move_to_end(key)
        while len(view) > self.staging_capacity:
            view.popitem(last=False)
            self.stage_evictions += 1

    def is_staged(self, executor_id: int, key: str) -> bool:
        view = self.staged.get(executor_id)
        if view is None or key not in view:
            return False
        view.move_to_end(key)      # keep LRU order aligned with the worker
        return True

    def unstage_executor(self, executor_id: int) -> None:
        """Forget everything staged on ``executor_id`` — its worker died
        or was replaced, so every key must re-ship."""
        self.staged.pop(executor_id, None)

    # ------------------------------------------------------------- fetches
    def fetch_cost(self, key: str, to_executor: int) -> float:
        """Seconds to make ``key`` local to ``to_executor`` (0 if local)."""
        sv = self._store[key]
        if to_executor in sv.placements or not sv.placements:
            return 0.0
        src = next(iter(sv.placements))
        cross_pod = (
            self.pod_of.get(src, 0) != self.pod_of.get(to_executor, 0)
        )
        return self.profiles.transfer_time(sv.nbytes, cross_pod=cross_pod)

    def fetch(self, key: str, to_executor: int) -> float:
        """Perform (account) the fetch; returns modeled seconds.

        With a chaos plane attached, a transfer may be lost in flight;
        the engine retries (each attempt pays the transfer again) up to
        ``max_fetch_retries``.  A fetch lost past the budget drops the
        key entirely and raises
        :class:`~repro_torch.core.faults.DataFetchError` carrying the lineage,
        so the coordinator can re-execute the producer."""
        sv = self._store[key]
        if to_executor in sv.placements or not sv.placements:
            self.num_local_hits += 1
            return 0.0
        cost = 0.0
        attempt = 0
        site = None
        if self.faults is not None:
            site = f"k{self._fetch_sites.setdefault(key, len(self._fetch_sites))}"
        while True:
            attempt += 1
            cost += self.fetch_cost(key, to_executor)
            if self.faults is None or not self.faults.fetch_lost(key, attempt, site):
                break
            if attempt > self.max_fetch_retries:
                # unrecoverable in transit: surface as a lost value so
                # lineage re-execution kicks in
                from repro_torch.core.faults import DataFetchError

                self.failed_fetches += 1
                lineage = sv.producer_node
                del self._store[key]
                raise DataFetchError(key, lineage)
            self.fetch_retries += 1
        sv.placements.add(to_executor)
        self.bytes_transferred += sv.nbytes
        self.num_transfers += 1
        return cost

    def batch_fetch_cost(self, keys: List[str], to_executor: int) -> float:
        """Transfers from distinct sources overlap; same-source serialize."""
        per_source: Dict[Optional[int], float] = {}
        for k in keys:
            sv = self._store.get(k)
            if sv is None or to_executor in sv.placements or not sv.placements:
                continue
            src = next(iter(sv.placements))
            per_source[src] = per_source.get(src, 0.0) + self.fetch_cost(k, to_executor)
        return max(per_source.values(), default=0.0)

    # ---------------------------------------------------------------- GC
    def addref(self, key: str, n: int = 1) -> None:
        self._store[key].refcount += n

    def release(self, key: str) -> None:
        sv = self._store.get(key)
        if sv is None:
            return
        sv.refcount -= 1
        if sv.refcount < self.min_refcount_seen:
            # a value released more often than it was referenced — the
            # invariant checker reads this watermark
            self.min_refcount_seen = sv.refcount
        if sv.refcount <= 0:
            del self._store[key]

    def pin(self, key: str) -> None:
        """Keep a value alive regardless of refcounts (workflow outputs)."""
        self._store[key].refcount += 10**9

    # ------------------------------------------------------------ failure
    def executor_lost(self, executor_id: int) -> List[Tuple[str, Optional[str]]]:
        """Drop placements on a dead executor; return (key, lineage) for
        values that now have no live copy and must be recomputed."""
        self.unstage_executor(executor_id)
        lost: List[Tuple[str, Optional[str]]] = []
        for key, sv in list(self._store.items()):
            if executor_id in sv.placements:
                sv.placements.discard(executor_id)
                if not sv.placements:
                    if (self.serialized and sv.payload is not None
                            and sv.refcount >= 1_000_000):
                        # pinned workflow output on the serialized plane:
                        # the bytes were shipped to the coordinator at
                        # commit, so the canonical copy survives worker
                        # loss (empty placements = frontend-local)
                        continue
                    lost.append((key, sv.producer_node))
                    del self._store[key]
        return lost

    # ------------------------------------------------------------- stats
    @property
    def live_bytes(self) -> int:
        return sum(sv.nbytes * max(1, len(sv.placements)) for sv in self._store.values())

    def __len__(self) -> int:
        return len(self._store)
