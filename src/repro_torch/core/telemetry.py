"""Unified metrics registry + telemetry gating — the counter half of the
telemetry plane.

Eight PRs grew ad-hoc instrumentation all over the runtime: plain-int
attribute counters on the coordinator (``n_requeues``), the backend
(``folded_evictions``), the proc plane (``n_fenced``), the datastore,
the autoscaler, and the fault plane.  This module federates them into
one process-wide :class:`MetricsRegistry` **without touching their
attribute APIs**: objects re-register onto the registry as *providers*
(held by weakref), and their attributes are read only at scrape time —
the hot paths keep doing ``self.n_x += 1`` on a plain int, which is as
close to zero-cost as instrumentation gets.

The registry also owns first-class instruments (labeled counter / gauge
/ histogram families) for signals that have no legacy attribute — e.g.
the coordinator's queue-delay histogram — plus a bounded ring of
**typed telemetry events** (:class:`FoldCacheEviction` replaces the
stringly ``("evict:<model_id>", 0)`` forward-log markers as the primary
eviction signal; the string marker remains as a compat shim).

Exported as a Prometheus-style text dump (:meth:`MetricsRegistry.
to_prometheus`).  Gating: ``REPRO_TELEMETRY`` enables the *tracer*
(:mod:`repro_torch.core.tracing`); the registry itself is always live because
scrape-time collection costs nothing until somebody scrapes.

Also home to :func:`validate_chrome_trace` — the CI gate that a
Chrome-trace export parses, its slices nest per track, and its flows
resolve (across pids for proc-plane traces)::

    PYTHONPATH=src python -m repro_torch.core.telemetry trace.json [--expect-multi-pid]
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import weakref
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "FoldCacheEviction",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TelemetryEvent",
    "configure",
    "default_registry",
    "telemetry_enabled",
    "validate_chrome_trace",
]

ENV_VAR = "REPRO_TELEMETRY"
_FALSY = ("", "0", "false", "off", "no")
_override: Optional[bool] = None


def telemetry_enabled() -> bool:
    """Tracer gate: ``REPRO_TELEMETRY`` truthy, or a :func:`configure`
    override (tests and benchmarks flip it programmatically)."""
    if _override is not None:
        return _override
    return os.environ.get(ENV_VAR, "").strip().lower() not in _FALSY


def configure(enabled: Optional[bool]) -> Optional[bool]:
    """Programmatic override of the env gate.  ``None`` restores env
    semantics.  Returns the previous override (restore it in tests)."""
    global _override
    prev = _override
    _override = enabled
    return prev


# ------------------------------------------------------------ instruments
class Counter:
    """Monotone float counter (one labeled series)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins float gauge (one labeled series)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    __slots__ = ("bounds", "counts", "sum", "count")

    DEFAULT_BOUNDS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                      2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, bounds: Optional[Tuple[float, ...]] = None) -> None:
        self.bounds = tuple(bounds if bounds is not None
                            else self.DEFAULT_BOUNDS)
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1


class _Family:
    """One named metric with labeled series, created lazily."""

    def __init__(self, kind: str, name: str, help: str,
                 labelnames: Tuple[str, ...],
                 bounds: Optional[Tuple[float, ...]] = None) -> None:
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.bounds = bounds
        self.series: Dict[Tuple[str, ...], Any] = {}

    def _make(self) -> Any:
        if self.kind == "counter":
            return Counter()
        if self.kind == "gauge":
            return Gauge()
        return Histogram(self.bounds)

    def labels(self, *values: Any, **kv: Any) -> Any:
        if kv:
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}")
        inst = self.series.get(values)
        if inst is None:
            inst = self.series[values] = self._make()
        return inst

    # unlabeled convenience: family.inc() == family.labels().inc()
    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)


# ------------------------------------------------------------ typed events
class TelemetryEvent:
    """Marker base for typed events on the registry's event ring."""


@dataclasses.dataclass(frozen=True)
class FoldCacheEviction(TelemetryEvent):
    """A LoRA-folded parameter set left the backend's fold-cache LRU.
    Replaces the stringly ``("evict:<model_id>", 0)`` forward-log marker
    as the primary signal (the marker survives as a compat shim)."""

    model_id: str
    patch_ids: Tuple[str, ...]
    resident_bytes: float


# --------------------------------------------------------------- registry
class MetricsRegistry:
    """Process-wide federation point for counters, gauges, histograms,
    provider objects, and typed events.

    *Providers* are existing runtime objects whose plain numeric
    attributes become gauge samples at scrape time.  They are held by
    weakref: a garbage-collected coordinator silently leaves the
    registry, so the module-level default registry never pins dead
    serving systems in tests."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        # (prefix, weakref(obj), attrs, labels)
        self._providers: List[Tuple[str, Any, Tuple[str, ...],
                                    Tuple[Tuple[str, str], ...]]] = []
        self.events: Deque[TelemetryEvent] = deque(maxlen=4096)
        self._event_counter = self.counter(
            "telemetry_events_total", "typed telemetry events emitted",
            labelnames=("type",))

    # ---------------------------------------------------------- families
    def _family(self, kind: str, name: str, help: str,
                labelnames: Iterable[str],
                bounds: Optional[Tuple[float, ...]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(
                kind, name, help, tuple(labelnames), bounds)
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> _Family:
        return self._family("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> _Family:
        return self._family("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  bounds: Optional[Tuple[float, ...]] = None) -> _Family:
        return self._family("histogram", name, help, labelnames, bounds)

    # ---------------------------------------------------------- providers
    def register_object(self, prefix: str, obj: Any,
                        attrs: Iterable[str],
                        labels: Optional[Dict[str, str]] = None) -> None:
        """Adopt ``obj``'s numeric attributes as ``<prefix>_<attr>``
        gauge samples, read at scrape time.  The object's attribute API
        is untouched; missing/non-numeric attributes are skipped."""
        self._providers.append((
            prefix, weakref.ref(obj), tuple(attrs),
            tuple(sorted((labels or {}).items()))))

    # ------------------------------------------------------------- events
    def emit(self, event: TelemetryEvent) -> None:
        self.events.append(event)
        self._event_counter.labels(type(event).__name__).inc()

    def events_of(self, cls: type) -> List[TelemetryEvent]:
        return [e for e in self.events if isinstance(e, cls)]

    # -------------------------------------------------------------- scrape
    def collect(self) -> List[Tuple[str, Dict[str, str], str, float]]:
        """Flat samples: (name, labels, kind, value).  Histogram series
        expand into ``_bucket``/``_sum``/``_count`` samples."""
        out: List[Tuple[str, Dict[str, str], str, float]] = []
        for fam in self._families.values():
            for lv, inst in fam.series.items():
                labels = dict(zip(fam.labelnames, lv))
                if fam.kind == "histogram":
                    acc = 0
                    for bound, c in zip(inst.bounds, inst.counts):
                        acc += c
                        out.append((fam.name + "_bucket",
                                    {**labels, "le": repr(bound)},
                                    "histogram", float(acc)))
                    out.append((fam.name + "_bucket",
                                {**labels, "le": "+Inf"}, "histogram",
                                float(inst.count)))
                    out.append((fam.name + "_sum", labels, "histogram",
                                inst.sum))
                    out.append((fam.name + "_count", labels, "histogram",
                                float(inst.count)))
                else:
                    out.append((fam.name, labels, fam.kind, inst.value))
        # provider attributes: summed across live registrants per
        # (name, labels) so fleets of executors aggregate naturally
        agg: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        for prefix, ref, attrs, labels in self._providers:
            obj = ref()
            if obj is None:
                continue
            for attr in attrs:
                v = getattr(obj, attr, None)
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    continue
                key = (f"{prefix}_{attr}", labels)
                agg[key] = agg.get(key, 0.0) + float(v)
        for (name, labels), v in sorted(agg.items()):
            out.append((name, dict(labels), "gauge", v))
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        typed: set = set()
        for fam in self._families.values():
            if not fam.series:
                continue
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            typed.add(fam.name)
        samples = self.collect()
        for name, labels, kind, value in samples:
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in typed:
                    base = name[:-len(suffix)]
            if base not in typed and kind == "gauge":
                lines.append(f"# TYPE {name} gauge")
                typed.add(name)
            if labels:
                lbl = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{lbl}}} {value:g}")
            else:
                lines.append(f"{name} {value:g}")
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry runtime objects register onto."""
    return _DEFAULT


# ------------------------------------------------------- trace validation
def validate_chrome_trace(path_or_obj: Any,
                          expect_multi_pid: bool = False) -> Dict[str, Any]:
    """CI gate for a Chrome trace-event export.

    Checks that the JSON parses, that ``X`` slices on each (pid, tid)
    track nest properly (no partial overlap), that every flow event
    (``s``/``t``/``f``) sits inside a slice on its track, and that each
    flow id starts with ``s`` before any ``t``/``f``.  With
    ``expect_multi_pid`` (proc-plane traces) at least one flow must span
    two distinct pids — the cross-process stitching guarantee.

    Returns summary stats; raises ``ValueError`` on any violation.
    """
    if isinstance(path_or_obj, dict):
        obj = path_or_obj
    else:
        with open(path_or_obj) as f:
            obj = json.load(f)
    events = obj["traceEvents"] if isinstance(obj, dict) else obj
    if not isinstance(events, list):
        raise ValueError("traceEvents is not a list")
    # export rounds timestamps to 1e-3 us; a slice end computed from two
    # rounded values can disagree with the next slice's rounded start by
    # a couple of ulp-of-rounding, so the tolerance sits above that
    eps = 5e-3
    slices: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    flows: Dict[Any, List[Tuple[float, str, int]]] = {}
    n_instants = n_async = 0
    for ev in events:
        ph = ev.get("ph")
        track = (ev.get("pid"), ev.get("tid"))
        if ph == "X":
            slices.setdefault(track, []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0))))
        elif ph in ("s", "t", "f"):
            flows.setdefault(ev.get("id"), []).append(
                (float(ev["ts"]), ph, ev.get("pid")))
        elif ph == "i":
            n_instants += 1
        elif ph in ("b", "e"):
            n_async += 1
    # slice nesting per track
    for track, spans in slices.items():
        stack: List[Tuple[float, float]] = []
        for s, e in sorted(spans, key=lambda x: (x[0], -x[1])):
            while stack and s >= stack[-1][1] - eps:
                stack.pop()
            if stack and e > stack[-1][1] + eps:
                raise ValueError(
                    f"track {track}: slice [{s}, {e}] partially overlaps "
                    f"enclosing [{stack[-1][0]}, {stack[-1][1]}]")
            stack.append((s, e))
    # flow containment + ordering
    track_slices = {t: sorted(sp) for t, sp in slices.items()}
    for ev in events:
        if ev.get("ph") not in ("s", "t", "f"):
            continue
        track = (ev.get("pid"), ev.get("tid"))
        ts = float(ev["ts"])
        spans = track_slices.get(track, [])
        if not any(s - eps <= ts <= e + eps for s, e in spans):
            raise ValueError(
                f"flow {ev.get('id')} ({ev['ph']}) at ts={ts} on track "
                f"{track} is not covered by any slice")
    multi_pid_flows = 0
    _ph_order = {"s": 0, "t": 1, "f": 2}
    for fid, steps in flows.items():
        steps.sort(key=lambda x: (x[0], _ph_order[x[1]]))
        if steps[0][1] != "s":
            raise ValueError(f"flow {fid}: first event is {steps[0][1]!r}, "
                             f"expected 's'")
        if len({pid for _, _, pid in steps}) > 1:
            multi_pid_flows += 1
    if expect_multi_pid and not multi_pid_flows:
        raise ValueError("expected at least one flow spanning multiple "
                         "pids (proc-plane stitching), found none")
    return {
        "n_events": len(events),
        "n_slices": sum(len(s) for s in slices.values()),
        "n_tracks": len(slices),
        "n_pids": len({pid for pid, _ in slices}),
        "n_flows": len(flows),
        "n_multi_pid_flows": multi_pid_flows,
        "n_instants": n_instants,
        "n_async": n_async,
    }


def _main(argv: Optional[List[str]] = None) -> int:   # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a Chrome trace-event JSON export")
    ap.add_argument("trace")
    ap.add_argument("--expect-multi-pid", action="store_true")
    ns = ap.parse_args(argv)
    stats = validate_chrome_trace(ns.trace,
                                  expect_multi_pid=ns.expect_multi_pid)
    print(json.dumps(stats, indent=2))
    return 0


if __name__ == "__main__":   # pragma: no cover
    raise SystemExit(_main())
