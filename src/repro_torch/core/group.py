"""Multi-coordinator sharding (§8 Discussion).

One coordinator managing N executors eventually bottlenecks; the paper
shards executors across multiple coordinators, **each managing a disjoint
subset of workflows that share models** (so sharding never destroys
model-sharing opportunities).  A cluster-management service handles
discovery/failure; here the group IS that service for the simulation
plane.

Partitioning: workflows are clustered by shared ``model_id``s (union-find
over each workflow's model set) and clusters are bin-packed onto
coordinators by expected work (serial seconds per request x popularity
proxy = 1), keeping every sharing opportunity within one coordinator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.core.profiles import GPU_H800, HardwareSpec, node_infer_time
from repro_torch.core.registry import ServingSystem
from repro_torch.core.workflow import WorkflowTemplate


class _UnionFind:
    def __init__(self) -> None:
        self.parent: Dict[str, str] = {}

    def find(self, x: str) -> str:
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def cluster_workflows(
    templates: Dict[str, WorkflowTemplate], registry_factory
) -> List[List[str]]:
    """Group workflow names into model-sharing clusters."""
    uf = _UnionFind()
    model_owner: Dict[str, str] = {}
    for name, tmpl in templates.items():
        graph = registry_factory(tmpl)
        uf.find(name)
        for mid in graph.model_ids():
            if mid in ("latents_generator", "denoise_step", "residual_combine"):
                continue                       # trivial ops shared by all
            if mid in model_owner:
                uf.union(name, model_owner[mid])
            else:
                model_owner[mid] = name
    clusters: Dict[str, List[str]] = {}
    for name in templates:
        clusters.setdefault(uf.find(name), []).append(name)
    return sorted(clusters.values(), key=len, reverse=True)


class CoordinatorGroup:
    """A fleet of ServingSystems, one per workflow-sharing cluster."""

    def __init__(
        self,
        templates: Dict[str, WorkflowTemplate],
        n_executors: int,
        max_coordinators: int = 4,
        hw: HardwareSpec = GPU_H800,
        admission_enabled: bool = True,
        autoscaler: Any = None,
        reserve_executors: int = 0,
    ) -> None:
        probe = ServingSystem(n_executors=1, hw=hw)

        def compile_graph(tmpl):
            probe.register(tmpl)
            return probe.registry.instantiate(tmpl.name)

        clusters = cluster_workflows(templates, compile_graph)
        n_coord = min(max_coordinators, len(clusters), max(1, n_executors // 2))
        # bin-pack clusters onto coordinators by expected serial work
        work = []
        for cl in clusters:
            w = sum(
                sum(node_infer_time(probe.profiles, n)
                    for n in probe.registry.instantiate(name).nodes
                    if not (n.attrs.get("inline") or n.attrs.get("io_only")))
                for name in cl
            )
            work.append((w, cl))
        bins: List[Tuple[float, List[str]]] = [(0.0, []) for _ in range(n_coord)]
        for w, cl in sorted(work, reverse=True, key=lambda x: x[0]):
            i = min(range(n_coord), key=lambda j: bins[j][0])
            bins[i] = (bins[i][0] + w, bins[i][1] + cl)
        total_w = sum(b[0] for b in bins) or 1.0
        # executors proportional to work, >=1 each
        sizes = [max(1, round(n_executors * b[0] / total_w)) for b in bins]
        while sum(sizes) > n_executors:
            sizes[sizes.index(max(sizes))] -= 1
        while sum(sizes) < n_executors:
            sizes[sizes.index(min(sizes))] += 1

        # reserves proportional to each shard's executor share (>=1 if any)
        reserves = [0] * len(sizes)
        if reserve_executors:
            reserves = [max(1, round(reserve_executors * s / n_executors))
                        for s in sizes]
            while sum(reserves) > reserve_executors:
                reserves[reserves.index(max(reserves))] -= 1
            while sum(reserves) < reserve_executors:
                reserves[reserves.index(min(reserves))] += 1

        # shards have independent clocks and fleets: a shared Autoscaler
        # instance would conflate their cooldowns/windows/action logs, so
        # each shard builds its own policy from the config
        from repro_torch.core.autoscaler import Autoscaler
        if isinstance(autoscaler, Autoscaler):
            autoscaler = autoscaler.config

        self.systems: List[ServingSystem] = []
        self.route: Dict[str, int] = {}
        for i, (b, size) in enumerate(zip(bins, sizes)):
            sys_ = ServingSystem(n_executors=size, hw=hw,
                                 admission_enabled=admission_enabled,
                                 autoscaler=autoscaler,
                                 reserve_executors=reserves[i])
            for name in b[1]:
                sys_.register(templates[name])
                self.route[name] = i
            self.systems.append(sys_)

    # ----------------------------------------------------------------- API
    def submit(self, workflow: str, **kw: Any):
        return self.systems[self.route[workflow]].submit(workflow, **kw)

    def run(self) -> None:
        # clusters are disjoint (no shared executors/models): event loops
        # are independent and can run to completion in any order
        for s in self.systems:
            s.run()

    # ------------------------------------------------------------- metrics
    def slo_attainment(self) -> float:
        done = sum(len(s.coordinator.finished) + len(s.coordinator.rejected)
                   for s in self.systems)
        att = sum(sum(1 for r in s.coordinator.finished if r.attained)
                  for s in self.systems)
        return att / done if done else 0.0

    def control_plane_time(self) -> float:
        return max(s.coordinator.control_plane_time for s in self.systems)

    def total_busy_time(self) -> float:
        return sum(s.coordinator.total_busy_time() for s in self.systems)

    @property
    def n_coordinators(self) -> int:
        return len(self.systems)
