"""SLO-aware early-abort admission control (§5.3).

Micro-serving gives the control plane per-node visibility into request
progress, so on arrival we can estimate a request's end-to-end completion
time as::

    est = now + backlog_work / |alive executors| + own critical path

where ``backlog_work`` sums the remaining critical paths of all inflight
requests (the coordinator tracks exactly which nodes each has completed).
The request is admitted only if ``est <= arrival + SLO``; otherwise it is
rejected immediately, preserving capacity for already-admitted requests.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.core.compiler import CompiledGraph
from repro_torch.core.profiles import ProfileStore, node_infer_time


def critical_path_seconds(
    graph: CompiledGraph, profiles: ProfileStore, completed: Optional[set] = None
) -> float:
    """Longest path (seconds) over not-yet-completed executor nodes."""
    completed = completed or set()
    finish: Dict[int, float] = {}
    best = 0.0
    for n in graph.nodes:  # topo order
        start = 0.0
        for ref in n.all_input_refs():
            if ref.producer is not None and ref.producer in finish:
                start = max(start, finish[ref.producer])
        if n.id in completed or n.attrs.get("inline") or n.attrs.get("io_only"):
            w = 0.0
        else:
            w = node_infer_time(profiles, n)
        finish[n.id] = start + w
        best = max(best, finish[n.id])
    return best


class AdmissionController:
    def __init__(self, profiles: ProfileStore, enabled: bool = True) -> None:
        self.profiles = profiles
        self.enabled = enabled
        self.admitted = 0
        self.rejected = 0

    def decide(
        self,
        now: float,
        graph: CompiledGraph,
        slo_seconds: Optional[float],
        inflight_remaining_work: float,
        n_executors: int,
    ) -> bool:
        if not self.enabled or slo_seconds is None:
            self.admitted += 1
            return True
        own = critical_path_seconds(graph, self.profiles)
        # processor-sharing estimate: the cluster works through the
        # inflight backlog plus this request together; a request "ahead in
        # line" only delays us by its share.  (own + backlog)/N was
        # measured tighter than own + backlog/N, which double-counts
        # requests that effectively own an idle executor —
        # see EXPERIMENTS.md §Perf.
        est_completion = (inflight_remaining_work + own) / max(1, n_executors)
        est_completion = max(est_completion, own)
        if est_completion <= slo_seconds:
            self.admitted += 1
            return True
        self.rejected += 1
        return False
