"""Chaos plane — deterministic fault injection for the serving runtime.

The paper's fault-tolerance story (immutable intermediates with recorded
lineage, re-execution on executor failure) only earns trust if failures
are *injectable, deterministic, and replayable*.  This module provides:

* :class:`FaultPlane` — a seeded fault schedule consulted by the
  :class:`~repro_torch.core.runtime.Coordinator` at dispatch, by the
  :class:`~repro_torch.core.datastore.DataEngine` on fetches, and by the
  backends.  Faults are keyed on **batch index** (dispatch counter) or
  **virtual time** plus a counter-indexed hash of the seed, never on wall
  clock or Python hash state — the same configuration replays the exact
  same fault schedule on every run and on every host.
* :class:`RetryPolicy` — the hardening knobs: per-batch execution
  timeouts, capped exponential-backoff retry with a bounded budget,
  executor quarantine thresholds, and datastore fetch retries.

Fault taxonomy (all independently schedulable):

``crash``       executor dies mid-batch (``alive = False``; optional
                revive after ``revive_after`` virtual seconds — a process
                restart with cold caches);
``slow``        a dispatched batch takes ``slow_factor`` times longer
                than modeled/measured (gray failure: may trip the
                timeout, may not);
``hang``        a dispatched batch never reports completion — only the
                per-batch timeout recovers it;
``transient``   the backend raises :class:`TransientBackendError` before
                any device work; retried with capped backoff inside the
                dispatch, then requeued through the lineage path;
``fetch_loss``  a datastore transfer is lost in flight; the engine
                retries, and a persistently failing fetch surfaces as
                :class:`DataFetchError` so the coordinator re-executes
                the producer (lineage recovery).

Process-plane faults (real fault domains — only meaningful with the
process-isolated backend, ``ProcBackend``, where executors are separate
OS processes):

``proc_kill``   SIGKILL the worker process the instant the exec frame is
                on the wire (``kill_every_execs`` cadence, bounded by
                ``max_kills``);
``blackhole``   the coordinator-side channel holds the worker's frames
                for ``blackhole_seconds`` wall seconds — heartbeats
                included, so the liveness monitor declares a zombie whose
                late ``exec_done`` must be epoch-fenced;
``frame_dup`` / ``frame_delay``
                a control frame is delivered twice / reordered behind the
                next poll's traffic (``frame_dup_p`` / ``frame_delay_p``
                per control frame, drawn from the seeded hash).

Everything is gated by the ``REPRO_FAULTS`` environment variable (see
:meth:`FaultPlane.from_env`); with it unset the serving system carries no
chaos machinery at all — not even timeout events.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple


class TransientBackendError(RuntimeError):
    """Injected (or real) recoverable backend failure: no device work
    happened; the dispatch may simply be retried."""


class DataFetchError(RuntimeError):
    """A datastore transfer failed past its retry budget.  Carries the
    lost key and its lineage so the coordinator can re-execute."""

    def __init__(self, key: str, lineage: Optional[str]) -> None:
        super().__init__(f"fetch of {key!r} failed past retry budget")
        self.key = key
        self.lineage = lineage


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Hardening knobs for the coordinator's failure handling.

    A batch whose completion has not been observed within
    ``timeout_factor`` times its expected duration (floored at
    ``timeout_floor`` seconds) is declared failed: its executors'
    runaway forwards are cancelled, the executors take a failure mark
    (quarantine accounting), and the nodes requeue with capped
    exponential backoff.  A node that exhausts ``node_retry_budget``
    requeues sheds its whole request — *exactly once* — instead of
    looping forever.
    """

    timeout_factor: float = 4.0       # x expected batch duration
    timeout_floor: float = 0.05       # s minimum timeout
    max_transient_retries: int = 3    # in-dispatch retries of a transient error
    backoff_base: float = 0.02        # s first retry delay
    backoff_cap: float = 1.0          # s max per-retry delay
    node_retry_budget: int = 6        # requeues before the request is shed
    # flapping-executor quarantine: >= quarantine_failures failure marks
    # within quarantine_window seconds drains the executor for
    # quarantine_seconds, then re-provisions it cold
    quarantine_failures: int = 3
    quarantine_window: float = 10.0
    quarantine_seconds: float = 5.0
    max_fetch_retries: int = 3        # datastore per-fetch retry budget

    def backoff(self, attempt: int) -> float:
        """Capped exponential backoff for the ``attempt``-th retry (1-based)."""
        return min(self.backoff_cap, self.backoff_base * (2 ** max(0, attempt - 1)))


@dataclasses.dataclass
class InjectedFault:
    """One realized fault, recorded in :attr:`FaultPlane.injected`."""

    at: float                 # virtual time of the decision
    kind: str                 # crash | slow | hang | transient | fetch_loss
    site: str                 # dispatch site / fetch key
    batch_index: Optional[int] = None
    executor_id: Optional[int] = None


class FaultPlane:
    """Seeded, deterministic fault schedule.

    Faults trigger either on a fixed cadence (``crash_every_batches``:
    crash the lead executor of every Nth dispatched batch, the acceptance
    criterion's schedule), at explicit virtual times (``crash_at``:
    ``(time, executor_id)`` pairs), or probabilistically per decision
    point with probabilities hashed from ``(seed, site, counter)`` — NOT
    from wall time or global RNG state, so a given configuration replays
    bit-identically.
    """

    def __init__(
        self,
        seed: int = 0,
        crash_every_batches: Optional[int] = None,
        crash_at: Tuple[Tuple[float, int], ...] = (),
        crash_p: float = 0.0,
        revive_after: Optional[float] = None,
        slow_p: float = 0.0,
        slow_factor: float = 8.0,
        hang_p: float = 0.0,
        transient_p: float = 0.0,
        fetch_loss_p: float = 0.0,
        max_crashes: Optional[int] = None,
        crash_frac: float = 0.5,
        kill_every_execs: Optional[int] = None,
        max_kills: Optional[int] = None,
        blackhole_exec: Optional[int] = None,
        blackhole_seconds: float = 0.5,
        frame_dup_p: float = 0.0,
        frame_delay_p: float = 0.0,
    ) -> None:
        self.seed = int(seed)
        self.crash_every_batches = crash_every_batches
        self.crash_at = tuple(crash_at)
        self.crash_p = crash_p
        self.revive_after = revive_after
        self.slow_p = slow_p
        self.slow_factor = slow_factor
        self.hang_p = hang_p
        self.transient_p = transient_p
        self.fetch_loss_p = fetch_loss_p
        self.max_crashes = max_crashes
        # where inside the batch window the crash lands (0..1)
        self.crash_frac = crash_frac
        # process-plane schedule (ProcBackend only)
        self.kill_every_execs = kill_every_execs
        self.max_kills = max_kills
        self.blackhole_exec = blackhole_exec
        self.blackhole_seconds = blackhole_seconds
        self.frame_dup_p = frame_dup_p
        self.frame_delay_p = frame_delay_p
        self.injected: List[InjectedFault] = []
        self.n_crashes = 0
        self.n_kills = 0

    # ----------------------------------------------------------- determinism
    def _u(self, site: str, counter: int) -> float:
        """Uniform [0, 1) drawn from a stable hash — replayable across
        processes (crc32 is PYTHONHASHSEED-independent)."""
        h = zlib.crc32(f"{self.seed}:{site}:{counter}".encode())
        return (h & 0xFFFFFF) / float(0x1000000)

    # ------------------------------------------------------------- dispatch
    def crash_now(self) -> bool:
        if self.max_crashes is not None and self.n_crashes >= self.max_crashes:
            return False
        self.n_crashes += 1
        return True

    def at_dispatch(self, batch_index: int, now: float) -> Optional[str]:
        """Fault decision for the ``batch_index``-th dispatched batch.
        Returns one of ``crash``/``slow``/``hang``/``transient`` or None.
        At most one fault fires per dispatch (crash wins)."""
        if (self.crash_every_batches
                and batch_index > 0
                and batch_index % self.crash_every_batches == 0
                and self.crash_now()):
            self._record(now, "crash", "dispatch", batch_index)
            return "crash"
        if self.crash_p and self._u("crash", batch_index) < self.crash_p \
                and self.crash_now():
            self._record(now, "crash", "dispatch", batch_index)
            return "crash"
        if self.hang_p and self._u("hang", batch_index) < self.hang_p:
            self._record(now, "hang", "dispatch", batch_index)
            return "hang"
        if self.transient_p and self._u("transient", batch_index) < self.transient_p:
            self._record(now, "transient", "dispatch", batch_index)
            return "transient"
        if self.slow_p and self._u("slow", batch_index) < self.slow_p:
            self._record(now, "slow", "dispatch", batch_index)
            return "slow"
        return None

    def transient_attempts(self, batch_index: int) -> int:
        """How many consecutive attempts the injected transient error
        survives (1 = first retry already succeeds)."""
        n = 1
        while self._u(f"transient_run:{batch_index}", n) < 0.5:
            n += 1
        return n

    # -------------------------------------------------------- process plane
    def proc_kill(self, exec_index: int) -> bool:
        """SIGKILL the worker serving the ``exec_index``-th RPC?  Fires on
        the ``kill_every_execs`` cadence, bounded by ``max_kills``."""
        if (not self.kill_every_execs
                or exec_index <= 0
                or exec_index % self.kill_every_execs != 0):
            return False
        if self.max_kills is not None and self.n_kills >= self.max_kills:
            return False
        self.n_kills += 1
        self._record(None, "proc_kill", f"exec:{exec_index}")
        return True

    def proc_blackhole(self, exec_index: int) -> float:
        """Wall seconds to blackhole the worker's channel starting at the
        ``exec_index``-th RPC (0.0 = no blackhole).  Holds *all* frames —
        heartbeats included — so the liveness lease expires while the
        process keeps running: the canonical partitioned zombie."""
        if self.blackhole_exec is None or exec_index != self.blackhole_exec:
            return 0.0
        self._record(None, "blackhole", f"exec:{exec_index}")
        return self.blackhole_seconds

    def frame_fault(self, worker_id: int, counter: int) -> Optional[str]:
        """Chaos decision for the ``counter``-th control frame received
        from ``worker_id``: ``dup``, ``delay``, or None."""
        if self.frame_dup_p and \
                self._u(f"frame_dup:w{worker_id}", counter) < self.frame_dup_p:
            self._record(None, "frame_dup", f"w{worker_id}:{counter}")
            return "dup"
        if self.frame_delay_p and \
                self._u(f"frame_delay:w{worker_id}", counter) < self.frame_delay_p:
            self._record(None, "frame_delay", f"w{worker_id}:{counter}")
            return "delay"
        return None

    # -------------------------------------------------------------- fetches
    def fetch_lost(self, key: str, attempt: int, site: Optional[str] = None) -> bool:
        """Is the ``attempt``-th transfer of ``key`` lost in flight?

        ``site`` overrides the hash site: the data engine passes a
        first-touch key index so the draw depends on the *timeline
        position* of the fetch, not on the raw key string (which embeds
        process-global node ids and would break same-process replay)."""
        if not self.fetch_loss_p:
            return False
        if self._u(f"fetch:{site if site is not None else key}", attempt) \
                < self.fetch_loss_p:
            self._record(None, "fetch_loss", key)
            return True
        return False

    # ------------------------------------------------------------- plumbing
    def _record(self, at: Optional[float], kind: str, site: str,
                batch_index: Optional[int] = None,
                executor_id: Optional[int] = None) -> None:
        self.injected.append(InjectedFault(
            at=0.0 if at is None else at, kind=kind, site=site,
            batch_index=batch_index, executor_id=executor_id))

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.injected:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    # ----------------------------------------------------------------- env
    @classmethod
    def from_env(cls, env: Optional[str] = None) -> Optional["FaultPlane"]:
        """Build a plane from ``REPRO_FAULTS`` (or an explicit spec).

        Spec grammar: comma-separated ``key=value`` pairs, e.g. ::

            REPRO_FAULTS="crash_every=5,revive=1.0,transient_p=0.05,seed=7"

        Keys: ``seed``, ``crash_every``, ``crash_p``, ``revive``,
        ``slow_p``, ``slow_factor``, ``hang_p``, ``transient_p``,
        ``fetch_loss_p``, ``max_crashes``, ``crash_frac``, and the
        process-plane schedule ``kill_every``, ``max_kills``,
        ``blackhole_exec``, ``blackhole_for``, ``frame_dup_p``,
        ``frame_delay_p``.  Unknown keys raise ``ValueError`` naming the
        key (a typo'd fault spec must not silently run fault-free).
        Unset, empty, or ``0`` disables the chaos plane entirely.
        """
        spec = os.environ.get("REPRO_FAULTS", "") if env is None else env
        spec = spec.strip()
        if not spec or spec == "0":
            return None
        kw: Dict[str, Any] = {}
        alias = {
            "crash_every": "crash_every_batches",
            "revive": "revive_after",
            "kill_every": "kill_every_execs",
            "blackhole_for": "blackhole_seconds",
        }
        int_keys = ("seed", "crash_every_batches", "max_crashes",
                    "kill_every_execs", "max_kills", "blackhole_exec")
        import inspect

        known = {p for p in inspect.signature(cls.__init__).parameters
                 if p not in ("self", "crash_at")}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"REPRO_FAULTS: bad item {part!r}")
            k, v = part.split("=", 1)
            k = alias.get(k.strip(), k.strip())
            if k not in known:
                raise ValueError(
                    f"REPRO_FAULTS: unknown key {k!r} "
                    f"(known: {', '.join(sorted(known | set(alias)))})")
            kw[k] = int(v) if k in int_keys else float(v)
        return cls(**kw)
