"""Serving metrics — SLO attainment and friends (§7.1 Metrics)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass
class RequestRecord:
    arrival: float
    workflow: str
    deadline: Optional[float]
    completion: Optional[float] = None   # None => rejected or unfinished
    rejected: bool = False

    @property
    def latency(self) -> Optional[float]:
        if self.completion is None:
            return None
        return self.completion - self.arrival

    @property
    def attained(self) -> bool:
        if self.rejected or self.completion is None or self.deadline is None:
            return False
        return self.completion <= self.deadline


def slo_attainment(records: Sequence[RequestRecord]) -> float:
    if not records:
        return 0.0
    return sum(1 for r in records if r.attained) / len(records)


def mean_latency(records: Sequence[RequestRecord]) -> float:
    """Mean latency over *completed* records.  Returns ``NaN`` when no
    record completed (rejected/unfinished requests have no latency) —
    callers must treat NaN as "no data", not as zero latency."""
    lats = [r.latency for r in records if r.latency is not None]
    return sum(lats) / len(lats) if lats else float("nan")


def quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Linearly interpolated quantile of an already-sorted sequence
    (numpy's default ``linear`` method): index ``q * (n - 1)`` with
    fractional positions interpolated between neighbours.  The previous
    ``int(q * n)`` index was biased — p50 of 2 samples read the max, and
    p99 of 100 samples hit the last element only via the min-clamp."""
    if not sorted_vals:
        return float("nan")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q={q} outside [0, 1]")
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def percentile_latency(records: Sequence[RequestRecord], q: float) -> float:
    """Interpolated latency quantile over completed records (see
    :func:`quantile`).  Returns ``NaN`` when no record completed."""
    lats = sorted(r.latency for r in records if r.latency is not None)
    if not lats:
        return float("nan")
    return quantile(lats, q)


def goodput(records: Sequence[RequestRecord], duration: float) -> float:
    """Attained requests per second.  A non-positive ``duration`` has no
    well-defined rate: returns ``NaN`` (previously 0.0, which silently
    read as "zero goodput" in comparisons)."""
    if duration <= 0:
        return float("nan")
    return sum(1 for r in records if r.attained) / duration


def executor_seconds(
    fleet_log: Sequence[tuple],
    t_end: float,
    initial: int,
    t_start: float = 0.0,
) -> float:
    """Integrate a step-function fleet timeline (the coordinator's
    ``fleet_log`` of ``(t, n_serving)`` transitions) over [t_start, t_end].
    Divide by the horizon for the time-weighted mean fleet size — the
    denominator of goodput-per-device, the autoscaler's efficiency
    metric."""
    if t_end <= t_start:
        return 0.0
    total, t, n = 0.0, t_start, initial
    for ts, ns in fleet_log:
        ts = min(max(ts, t_start), t_end)
        total += n * (ts - t)
        t, n = ts, ns
    total += n * (t_end - t)
    return total


def mean_fleet_size(fleet_log: Sequence[tuple], t_end: float, initial: int,
                    t_start: float = 0.0) -> float:
    horizon = t_end - t_start
    if horizon <= 0:
        return float(initial)
    return executor_seconds(fleet_log, t_end, initial, t_start) / horizon


def latency_cdf(records: Sequence[RequestRecord], points: int = 50) -> List[tuple]:
    lats = sorted(r.latency for r in records if r.latency is not None)
    if not lats:
        return []
    out = []
    for i in range(points + 1):
        q = i / points
        out.append((quantile(lats, q), q))
    return out
