"""Request-scoped span tracer — the timeline half of the telemetry plane.

Every admitted request carries a **trace id** (its ``rid``) from
admission through scheduler queueing, dispatch, segment chunks, retries,
quarantines, and recovery replays.  The coordinator records spans in
**virtual time** (its event-loop clock), so the same schema covers both
planes: sim arms get timelines for free, and the executable plane's
measured wall durations *are* its virtual durations.

Worker processes (the process plane, ``ProcBackend``) measure their spans
in wall seconds **relative to RPC receipt**; the parent rebases them onto
the virtual dispatch timestamp when the reply lands.  Because a proc
RPC's wall time is exactly the batch's virtual window, rebased worker
spans nest inside their dispatch span with no clock-offset bookkeeping.
Fenced zombie replies are rebased the same way but land on a dedicated
``fenced`` track — orphaned, yet attributed to the request that issued
the RPC.

Events live on **tracks** keyed ``(pid, tid)``: the coordinator is the
synthetic pid ``0`` (``requests``/``control``/``exec<N>`` threads); each
worker process contributes tracks under its real OS pid.  Exporters:

* :meth:`Tracer.export_chrome` — Chrome trace-event JSON (loadable in
  Perfetto / ``chrome://tracing``): ``X`` duration slices, ``b``/``e``
  async request spans, ``s``/``t``/``f`` flows linking one request's
  slices across tracks, ``M`` process/thread-name metadata;
* :meth:`Tracer.export_jsonl` — one raw event per line (the span schema
  verbatim, for programmatic consumers).

The disabled path is near-zero-cost: :func:`make_tracer` returns the
shared :data:`NULL_TRACER` singleton whose methods are no-ops, and every
instrumentation site in the runtime guards on ``tracer.enabled`` before
building any argument dict — disabled runs allocate nothing.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

COORDINATOR_PID = 0

__all__ = [
    "COORDINATOR_PID",
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "make_tracer",
]


class Tracer:
    """Append-only event buffer with Chrome/JSONL exporters.

    Timestamps and durations are **virtual seconds** (converted to the
    microseconds Chrome expects only at export).  The buffer is bounded:
    past ``max_events`` new events are dropped and counted, so a runaway
    trace cannot exhaust memory.
    """

    enabled = True

    def __init__(self, max_events: int = 500_000) -> None:
        self.events: List[Dict[str, Any]] = []
        self.max_events = max_events
        self.n_dropped = 0
        self._process_names: Dict[int, str] = {COORDINATOR_PID: "coordinator"}
        self._thread_names: Dict[Tuple[int, str], str] = {}
        self._flow_seen: set = set()   # trace ids with an emitted flow root

    # ------------------------------------------------------------- record
    def _emit(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.n_dropped += 1
            return
        self.events.append(ev)

    def begin_request(self, trace: int, name: str, ts: float,
                      args: Optional[Dict[str, Any]] = None) -> None:
        """Async request span opens on the ``requests`` track."""
        self._emit({"ph": "b", "name": name, "cat": "request", "ts": ts,
                    "pid": COORDINATOR_PID, "tid": "requests",
                    "trace": trace, "args": args or {}})

    def end_request(self, trace: int, name: str, ts: float,
                    status: str = "done") -> None:
        self._emit({"ph": "e", "name": name, "cat": "request", "ts": ts,
                    "pid": COORDINATOR_PID, "tid": "requests",
                    "trace": trace, "args": {"status": status}})

    def span(self, name: str, ts: float, dur: float, pid: int, tid: str,
             cat: str = "", trace: Optional[int] = None,
             args: Optional[Dict[str, Any]] = None) -> None:
        """Complete duration slice (recorded once the end is known)."""
        self._emit({"ph": "X", "name": name, "cat": cat, "ts": ts,
                    "dur": max(0.0, dur), "pid": pid, "tid": tid,
                    "trace": trace, "args": args or {}})

    def instant(self, name: str, ts: float, pid: int, tid: str,
                cat: str = "", trace: Optional[int] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        self._emit({"ph": "i", "name": name, "cat": cat, "ts": ts,
                    "pid": pid, "tid": tid, "trace": trace,
                    "args": args or {}})

    def flow(self, trace: int, ts: float, pid: int, tid: str,
             end: bool = False, step: bool = False) -> None:
        """One step of a request's cross-track flow.  The first emission
        per trace id is the flow root (``s``), later ones are steps
        (``t``), and ``end=True`` finishes it (``f``).  ``step=True``
        refuses to become the root (emitted only when a root already
        exists) — used for worker-side steps, which are *recorded* before
        the enclosing dispatch slice closes but *timestamped* after it
        starts, so the root must stay on the coordinator track.  Callers
        must place each step at a timestamp covered by a slice on the
        same track — Chrome binds flow arrows to enclosing slices."""
        if end or step:
            if trace not in self._flow_seen:
                return   # no flow root was ever emitted for this trace
            ph = "f" if end else "t"
        elif trace in self._flow_seen:
            ph = "t"
        else:
            ph = "s"
            self._flow_seen.add(trace)
        self._emit({"ph": ph, "name": "request", "cat": "flow", "ts": ts,
                    "pid": pid, "tid": tid, "trace": trace, "args": {}})

    def set_process_name(self, pid: int, name: str) -> None:
        self._process_names.setdefault(pid, name)

    def set_thread_name(self, pid: int, tid: str, name: str) -> None:
        self._thread_names.setdefault((pid, tid), name)

    # ------------------------------------------------------------- export
    def _tid_map(self) -> Dict[Tuple[int, str], int]:
        """Stable integer thread ids per (pid, tid-string) track."""
        tracks = sorted({(ev["pid"], ev["tid"]) for ev in self.events})
        ids: Dict[Tuple[int, str], int] = {}
        per_pid: Dict[int, int] = {}
        for pid, tid in tracks:
            per_pid[pid] = per_pid.get(pid, 0) + 1
            ids[(pid, tid)] = per_pid[pid]
        return ids

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object format (Perfetto-loadable)."""
        tid_of = self._tid_map()
        # Flow roots are re-derived here: batches close out of dispatch
        # order (a later-dispatched batch can finish first), so the
        # first step recorded for a request is not always the earliest
        # on the timeline — and Chrome requires the "s" to come first.
        flow_root: Dict[Any, int] = {}
        for i, ev in enumerate(self.events):
            if ev["ph"] in ("s", "t"):
                j = flow_root.get(ev["trace"])
                if j is None or ev["ts"] < self.events[j]["ts"]:
                    flow_root[ev["trace"]] = i
        out: List[Dict[str, Any]] = []
        for pid in sorted({p for p, _ in tid_of}):
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": self._process_names.get(
                            pid, f"pid {pid}")}})
            out.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                        "tid": 0, "args": {"sort_index": pid}})
        for (pid, tid), n in tid_of.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": n, "args": {"name": self._thread_names.get(
                            (pid, tid), tid)}})
        for i, ev in enumerate(self.events):
            ph = ev["ph"]
            if ph in ("s", "t"):
                ph = "s" if flow_root.get(ev["trace"]) == i else "t"
            e: Dict[str, Any] = {
                "ph": ph, "name": ev["name"], "cat": ev.get("cat") or "event",
                "ts": round(ev["ts"] * 1e6, 3), "pid": ev["pid"],
                "tid": tid_of[(ev["pid"], ev["tid"])],
            }
            if ph == "X":
                e["dur"] = round(ev["dur"] * 1e6, 3)
            if ph == "i":
                e["s"] = "t"
            if ph in ("b", "e"):
                e["id"] = ev["trace"]
            if ph in ("s", "t", "f"):
                e["id"] = ev["trace"]
                if ph == "f":
                    e["bp"] = "e"
            args = dict(ev.get("args") or {})
            if ev.get("trace") is not None and ph not in ("s", "t", "f"):
                args.setdefault("trace", ev["trace"])
            if args:
                e["args"] = args
            out.append(e)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def export_jsonl(self, path: str) -> None:
        """Raw span schema, one JSON object per line."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")


class NullTracer:
    """Shared no-op tracer: the ``REPRO_TELEMETRY``-disabled path.

    Every method returns immediately; instrumentation sites additionally
    guard on :attr:`enabled` so argument dicts are never even built."""

    enabled = False
    events: List[Dict[str, Any]] = []
    n_dropped = 0

    def begin_request(self, *a: Any, **kw: Any) -> None:
        pass

    def end_request(self, *a: Any, **kw: Any) -> None:
        pass

    def span(self, *a: Any, **kw: Any) -> None:
        pass

    def instant(self, *a: Any, **kw: Any) -> None:
        pass

    def flow(self, *a: Any, **kw: Any) -> None:
        pass

    def set_process_name(self, *a: Any, **kw: Any) -> None:
        pass

    def set_thread_name(self, *a: Any, **kw: Any) -> None:
        pass

    def export_chrome(self, path: str) -> None:
        raise RuntimeError("telemetry disabled: no trace recorded "
                           "(set REPRO_TELEMETRY=1 or configure(True))")

    export_jsonl = export_chrome

    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": []}


NULL_TRACER = NullTracer()


def make_tracer(enabled: Optional[bool] = None) -> Any:
    """A :class:`Tracer` when telemetry is on, else the shared no-op
    singleton.  ``enabled=None`` consults ``REPRO_TELEMETRY`` (and any
    :func:`repro_torch.core.telemetry.configure` override)."""
    if enabled is None:
        from repro_torch.core.telemetry import telemetry_enabled

        enabled = telemetry_enabled()
    return Tracer() if enabled else NULL_TRACER
