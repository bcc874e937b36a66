"""Workflow-node scheduler — Algorithm 1 of the paper (§5).

Per scheduling cycle:

1. order the ready queue FCFS, tie-broken by DAG depth (shallower first);
2. pop the head node, batch every other ready node that references the
   *same model with the same effective patch set* up to the profiled
   ``B_max`` — cross-workflow model sharing (§5.1);
3. pick the parallelism degree ``k = min(|E_avail|, k_max)`` —
   work-conserving adaptive parallelism (§5.2);
4. score every available executor ``L_data + L_load + L_infer`` (warm
   models make ``L_load = 0`` via the model state table) and dispatch to
   the ``k`` lowest-scoring executors.

The scheduler is a pluggable policy object: it *decides*; the coordinator
(:mod:`repro_torch.core.runtime`) *acts*.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.executor import Executor
from repro_torch.core.profiles import LatencyProfile, ProfileStore


@dataclasses.dataclass
class ScheduledBatch:
    """One dispatch decision."""

    nodes: List[Any]                   # RequestNode list (same model+patches)
    model_id: str
    executor_ids: List[int]            # k executors; [0] is the lead
    parallelism: int
    batch_size: int
    l_data: float
    l_load: float
    l_infer: float
    patch_swap: float
    # segment nodes only: how many fused denoise steps this dispatch runs
    # (the load-adaptive chunk); 1 for ordinary nodes
    segment_steps: int = 1
    # True when the batch mixes requests with DIFFERENT effective patch
    # sets (grouped multi-LoRA): the coordinator then routes per-request
    # patches through the backend's adapter pool instead of mutating the
    # executors' folded patch state
    multilora: bool = False
    # > 0 for an OVERLAPPED dispatch (REPRO_OVERLAP): seconds of the
    # target executor's in-flight denoise segment still to run at
    # dispatch time.  ``l_infer`` is then already the EXPOSED price
    # (``LatencyProfile.exposed_infer_time``), and the coordinator
    # appends the occupancy at the executor's current busy horizon
    # instead of claiming a free one.
    overlap_window: float = 0.0

    @property
    def duration(self) -> float:
        return self.l_data + self.l_load + self.patch_swap + self.l_infer


class Scheduler:
    """FCFS + depth, same-model batching, score-based placement."""

    def __init__(
        self,
        profiles: ProfileStore,
        adaptive_parallelism: bool = True,
        enable_sharing: bool = True,
        fixed_parallelism: Optional[int] = None,
        max_parallelism_cap: Optional[int] = None,
        max_batch_cap: Optional[int] = None,
        use_declared_max_batch: bool = False,
        mesh: Optional[Any] = None,
        segment_chunk: Optional[int] = None,
        multilora: bool = True,
    ) -> None:
        self.profiles = profiles
        self.adaptive_parallelism = adaptive_parallelism
        self.enable_sharing = enable_sharing
        self.fixed_parallelism = fixed_parallelism
        self.max_parallelism_cap = max_parallelism_cap
        # MeshManager (sharded executable plane): k is clamped to the
        # largest submesh the available executors' devices can form, and
        # placement prefers executors on distinct devices
        self.mesh = mesh
        # cap on cross-request batch size (ablation/benchmark knob;
        # max_batch_cap=1 forces per-request sequential dispatch)
        self.max_batch_cap = max_batch_cap
        # executable plane: batch up to the model's DECLARED B_max
        # (ModelCost.max_batch) instead of the analytic profile's effective
        # B_max, which is derived from real-scale costs and says nothing
        # about the measured toy models actually being executed
        self.use_declared_max_batch = use_declared_max_batch
        # fixed segment chunk size (benchmark/ablation knob); None means
        # load-adaptive chunking via choose_segment_steps
        self.segment_chunk = segment_chunk
        # multi-tenant adapter batching: when the model declares
        # supports_multilora, stop partitioning batches by patch set —
        # requests carrying different LoRAs share one grouped forward.
        # False restores strict per-patch-set batching (the fold-cache
        # arm of the multitenant benchmark)
        self.multilora = multilora
        # telemetry providers (scrape-time; see repro_torch.core.telemetry):
        # scheduling cycles that found work, and batches formed
        self.n_cycles = 0
        self.n_batches = 0

    # ----------------------------------------------------------- ordering
    @staticmethod
    def order_key(rnode: Any) -> Tuple[float, int, int]:
        return (rnode.arrival_time, rnode.depth, rnode.seq)

    # ------------------------------------------------------------ batching
    def form_batch(self, head: Any, ready: Sequence[Any]) -> List[Any]:
        profile = self.profiles.get(head.model_id)
        max_batch = (profile.cost.max_batch if self.use_declared_max_batch
                     else profile.max_batch)
        if self.max_batch_cap is not None:
            max_batch = min(max_batch, self.max_batch_cap)
        batch = [head]
        if not self.enable_sharing:
            # monolithic-style: only batch nodes from the same workflow type
            for rn in ready:
                if len(batch) >= max_batch:
                    break
                if (
                    rn is not head
                    and rn.batch_key == head.batch_key
                    and rn.request.workflow_name == head.request.workflow_name
                ):
                    batch.append(rn)
            return batch
        for rn in ready:
            if len(batch) >= max_batch:
                break
            if rn is head:
                continue
            if rn.batch_key == head.batch_key:
                batch.append(rn)
            elif (
                self.multilora
                and rn.model_id == head.model_id
                and getattr(getattr(head, "node", None), "op", None) is not None
                and getattr(head.node.op, "supports_multilora", False)
                and len(head.effective_patches) <= 1
                and len(rn.effective_patches) <= 1
            ):
                # grouped multi-LoRA (§5.1 extended): the model runs one
                # stacked forward applying a DIFFERENT adapter per row, so
                # requests for different tenants share the batch.  Bounded
                # to single-patch requests — the grouped kernel indexes one
                # adapter per row
                batch.append(rn)
        return batch

    # --------------------------------------------------------- parallelism
    def choose_parallelism(self, model_id: str, n_avail: int,
                           n_queued: int = 0, low_load: bool = True,
                           avail_ids: Optional[Sequence[int]] = None) -> int:
        profile = self.profiles.get(model_id)
        k_max = profile.max_parallelism
        if self.max_parallelism_cap is not None:
            k_max = min(k_max, self.max_parallelism_cap)
        if self.mesh is not None:
            # sharded plane: k beyond an assemblable submesh would dispatch
            # a parallel batch that cannot actually shard — clamp to the
            # fleet-wide device ceiling here so the decision reflects real
            # placement (§5.2)
            k_max = min(k_max, self.mesh.max_k())
        if self.fixed_parallelism is not None:
            # static parallelism clamps to the FLEET ceiling only: when
            # fewer than k executors are free it must keep waiting for a
            # free device group (Fig 4), not degrade to what is free now
            return max(1, min(self.fixed_parallelism, k_max))
        if not self.adaptive_parallelism:
            return 1
        if self.mesh is not None and avail_ids is not None:
            # adaptive (work-conserving) parallelism is free to use
            # whatever submesh the currently-free executors can form
            k_max = min(k_max, max(1, self.mesh.assemblable(avail_ids)))
        # work-conserving AND throughput-preserving: intra-node parallelism
        # trades 2 GPUs for ~1.9x latency — a win only when the cluster has
        # genuine spare capacity (inflight < fleet) and no batch would
        # starve.  (Beyond-paper refinement; the paper's bare
        # k=min(|E_avail|, k_max) loses ~2x throughput at saturation —
        # see EXPERIMENTS.md §Perf.)
        if not low_load or n_queued >= n_avail:
            return 1
        return max(1, min(n_avail, k_max))

    # --------------------------------------------------------- chunk sizing
    def choose_segment_steps(self, remaining: int, n_queued: int,
                             low_load: bool = True,
                             patches_pending: bool = False) -> int:
        """Load-adaptive segment granularity (the paper's §5.2 argument
        that granularity is a *scheduling decision*): run the whole
        remaining chain in one scan when nothing else is waiting (minimal
        per-node overhead), drop to step granularity under queue pressure
        so later arrivals can join cross-request step-level batches and
        the sharding machinery keeps its per-step placement freedom.  An
        in-flight adapter fetch also forces step granularity — the
        adapter must be able to fold in at the next chunk boundary (Katz
        semantics); a monolithic chunk would run the whole request
        unpatched.  A fixed ``segment_chunk`` (benchmark knob) overrides
        the load policy but not the patch bound.

        The load signal is QUEUE DEPTH after batch formation, not the
        inflight count: when every ready node is inside this batch, the
        full scan is optimal no matter how many requests are in it —
        nothing is left behind to starve."""
        remaining = max(1, int(remaining))
        if patches_pending:
            return 1
        if self.segment_chunk is not None:
            return max(1, min(remaining, self.segment_chunk))
        if n_queued <= 0:
            return remaining
        return 1

    # -------------------------------------------------------------- scoring
    def score_executors(
        self,
        batch: List[Any],
        executors: Sequence[Executor],
        k: int,
        data_fetch_cost: Callable[[List[Any], int], float],
        steps: int = 1,
        multilora: bool = False,
    ) -> Tuple[List[Executor], float, float, float, float]:
        """Returns (k best executors, l_data, l_load, l_infer, patch_swap)
        evaluated at the chosen placement."""
        model_id = batch[0].model_id
        profile = self.profiles.get(model_id)
        want_patches = list(batch[0].effective_patches)
        adapters = 0
        if multilora:
            # unfolded grouped serving: adapters ride the executor's pool,
            # never fold into resident params — no hot-patch swap is paid
            # anywhere, and the infer estimate instead carries the grouped
            # forward's rank/adapter term
            adapters = len({p for rn in batch for p in rn.effective_patches})
        scored: List[Tuple[float, float, float, float, Executor]] = []
        for e in executors:
            l_data = data_fetch_cost(batch, e.id)
            l_load = 0.0 if e.has_model(model_id) else profile.load_time()
            swap = 0.0
            if multilora:
                pass
            elif e.has_model(model_id) and e.patches_on(model_id) != want_patches:
                swap = self.profiles.hw.patch_swap_time
            elif not e.has_model(model_id) and want_patches:
                swap = self.profiles.hw.patch_swap_time
            l_infer = profile.infer_time(len(batch), k, steps=steps,
                                         adapters=adapters)
            score = l_data + l_load + swap + l_infer
            scored.append((score, l_data, l_load, swap, e))
        # equal-score tie-break: executors the autoscaler assigned to this
        # model first, so scaled-up groups absorb their model's traffic
        scored.sort(key=lambda s: (
            s[0], 0 if model_id in s[4].assigned_models else 1, s[4].id))
        if self.mesh is not None and k > 1:
            # the k executors must own k distinct devices or the submesh
            # collapses: greedily take the best-scoring executor per device
            top, seen = [], set()
            for s in scored:
                dev = id(self.mesh.device_of(s[4].id))
                if dev in seen:
                    continue
                seen.add(dev)
                top.append(s)
                if len(top) == k:
                    break
            if len(top) < k:
                # adaptive k is clamped to assemblable and the fixed path
                # waits for a device group, so only a mid-cycle change of
                # the avail set lands here; fill by score as a best effort
                chosen = {id(s) for s in top}
                top += [s for s in scored
                        if id(s) not in chosen][:k - len(top)]
        else:
            top = scored[:k]
        lead = top[0]
        return (
            [s[4] for s in top],
            lead[1],
            max(s[2] for s in top),   # parallel loads overlap; bound by max
            self.profiles.get(model_id).infer_time(len(batch), k, steps=steps,
                                                   adapters=adapters),
            max(s[3] for s in top),
        )

    # --------------------------------------------------- overlap placement
    def overlap_decision(
        self,
        ready: List[Any],
        overlap_avail: Sequence[Tuple[Executor, float]],
        data_fetch_cost: Callable[[List[Any], int], float],
    ) -> Optional[ScheduledBatch]:
        """Fallback placement when no executor is free (REPRO_OVERLAP):
        dispatch the first ready node whose model declares
        ``overlappable`` onto an executor still running a denoise
        segment, pricing ``l_infer`` at the EXPOSED cost — the segment's
        remaining window hides that much of the decode for free.
        ``overlap_avail`` pairs each candidate with its window estimate.
        FCFS is preserved in spirit: skipped heads have no free executor
        to claim anyway, so running a later decode is work-conserving."""
        head = next(
            (rn for rn in ready
             if getattr(getattr(getattr(rn, "node", None), "op", None),
                        "overlappable", False)), None)
        if head is None:
            return None
        batch = self.form_batch(head, ready)
        profile = self.profiles.get(head.model_id)
        want_patches = list(head.effective_patches)
        best: Optional[Tuple[float, Executor, float, float, float, float, float]] = None
        for e, window in overlap_avail:
            l_data = data_fetch_cost(batch, e.id)
            l_load = 0.0 if e.has_model(head.model_id) else profile.load_time()
            swap = 0.0
            if e.has_model(head.model_id) \
                    and e.patches_on(head.model_id) != want_patches:
                swap = self.profiles.hw.patch_swap_time
            elif not e.has_model(head.model_id) and want_patches:
                swap = self.profiles.hw.patch_swap_time
            # overlapped dispatch is always k=1: its peers are busy, and
            # a sharded decode could not interleave under the segment
            l_infer = profile.exposed_infer_time(
                len(batch), 1, overlap_window=window)
            score = l_data + l_load + swap + l_infer
            if best is None or score < best[0]:
                best = (score, e, window, l_data, l_load, swap, l_infer)
        if best is None:
            return None
        _, e, window, l_data, l_load, swap, l_infer = best
        self.n_batches += 1
        return ScheduledBatch(
            nodes=batch,
            model_id=head.model_id,
            executor_ids=[e.id],
            parallelism=1,
            batch_size=len(batch),
            l_data=l_data,
            l_load=l_load,
            l_infer=l_infer,
            patch_swap=swap,
            segment_steps=1,
            overlap_window=window,
        )

    # ------------------------------------------------------------ top-level
    def schedule_cycle(
        self,
        ready: List[Any],
        executors: Sequence[Executor],
        data_fetch_cost: Callable[[List[Any], int], float],
        low_load: bool = True,
        overlap: Optional[Sequence[Executor]] = None,
        now: float = 0.0,
    ) -> List[ScheduledBatch]:
        """One full scheduling cycle: greedily drain ready nodes onto free
        executors.  ``ready`` is mutated (dispatched nodes removed).

        ``overlap`` (REPRO_OVERLAP; ``None`` = feature off) lists busy
        executors still running a denoise segment with a free overlap
        slot.  Executors handed a segment WITHIN this cycle join the
        candidate set too — a scheduling cycle runs exactly when
        executors free up, so the decode that chases a segment is
        almost always decided in the same cycle that dispatched it.
        Once the free pool drains, overlappable models ride these
        candidates at exposed cost."""
        decisions: List[ScheduledBatch] = []
        self.n_cycles += 1
        # only SERVING executors take work: warming/draining/reserve fleet
        # members are invisible to placement (caller pre-filters by freeness)
        avail = [e for e in executors if e.is_serving]
        overlap_on = overlap is not None
        overlap_avail: List[Tuple[Executor, float]] = (
            [(e, max(0.0, e.busy_until - now)) for e in overlap
             if e.is_serving] if overlap_on else [])
        ready.sort(key=self.order_key)
        while ready and (avail or overlap_avail):
            if not avail:
                d = self.overlap_decision(ready, overlap_avail,
                                          data_fetch_cost)
                if d is None:
                    break
                decisions.append(d)
                dispatched = set(id(n) for n in d.nodes)
                ready[:] = [n for n in ready if id(n) not in dispatched]
                overlap_avail = [(e, w) for e, w in overlap_avail
                                 if e.id not in d.executor_ids]
                continue
            head = ready[0]
            batch = self.form_batch(head, ready)
            n_queued = len(ready) - len(batch)
            k = self.choose_parallelism(head.model_id, len(avail),
                                        n_queued=n_queued,
                                        low_load=low_load,
                                        avail_ids=[e.id for e in avail])
            op = getattr(getattr(head, "node", None), "op", None)
            if k > 1 and op is not None and hasattr(op, "clamp_parallelism"):
                # model-declared feasibility: don't reserve devices a
                # sharded forward of this batch shape cannot use
                k = max(1, min(k, op.clamp_parallelism(len(batch), k)))
            chunk = 1
            if getattr(head, "segment_remaining", None) is not None:
                # segment granularity is chosen HERE, per dispatch: the
                # chunk covers at most the least-advanced node in the batch
                chunk = self.choose_segment_steps(
                    min(rn.segment_remaining for rn in batch),
                    n_queued=n_queued, low_load=low_load,
                    patches_pending=any(
                        getattr(rn, "patches_pending", False) for rn in batch))
            if (self.fixed_parallelism is not None
                    and self.profiles.get(head.model_id).max_parallelism > 1
                    and (k > len(avail)
                         or (self.mesh is not None and k > 1
                             and self.mesh.assemblable(
                                 [e.id for e in avail]) < k))):
                # static parallelism waits for a free device group (Fig 4):
                # not enough free executors, or the free ones share devices
                # and cannot assemble a k-wide submesh
                break
            ml = any(rn.batch_key != head.batch_key for rn in batch)
            self.n_batches += 1
            targets, l_data, l_load, l_infer, swap = self.score_executors(
                batch, avail, k, data_fetch_cost, steps=chunk, multilora=ml
            )
            decisions.append(
                ScheduledBatch(
                    nodes=batch,
                    model_id=head.model_id,
                    executor_ids=[e.id for e in targets],
                    parallelism=k,
                    batch_size=len(batch),
                    l_data=l_data,
                    l_load=l_load,
                    l_infer=l_infer,
                    patch_swap=swap,
                    segment_steps=chunk,
                    multilora=ml,
                )
            )
            dispatched = set(id(n) for n in batch)
            ready[:] = [n for n in ready if id(n) not in dispatched]
            taken = set(e.id for e in targets)
            avail = [e for e in avail if e.id not in taken]
            if overlap_on and getattr(getattr(head.node, "op", None),
                                      "is_segment", False):
                # the executors just claimed open a fresh segment window:
                # later decisions in THIS cycle may overlap it, with the
                # batch's own duration estimate as the hiding window
                overlap_avail.extend(
                    (e, decisions[-1].duration) for e in targets)
        return decisions
