"""Per-model autoscaling — elastic micro-serving (§4.3.1, §8).

The paper's headline burst results come from scaling *individual models*,
not whole workflows: when traffic shifts toward one workflow node (say the
SDXL backbone), only that model's executor group grows.  Monolithic
baselines must replicate the entire workflow — every model in it — to add
capacity, which is both slower (loads the full footprint) and wasteful.

The :class:`Autoscaler` is a pure policy object, symmetric with the
:class:`~repro_torch.core.scheduler.Scheduler`: it *decides*, the
:class:`~repro_torch.core.runtime.Coordinator` *acts*.  On every control tick it
reads three per-model demand signals over a sliding window:

* **ready-queue depth** — READY nodes per model in the coordinator queue;
* **queueing delay vs. SLO headroom** — how long the head node has waited,
  relative to the headroom its request's deadline still allows;
* **warm-model utilization** — from the model state table: how many
  serving executors hold the model, and how busy they are.

and emits :class:`ScaleAction`\\ s:

* ``scale_up`` — take an executor (idle serving executor without the
  model, or a cold reserve executor) through the warm-pool handoff:
  *provisioning → warming* (weights stream host→HBM off the dispatch
  critical path) *→ serving*.  The first batch admitted after the handoff
  sees ``L_load = 0``.
* ``scale_down`` — drain an executor's assignment for the model
  (*serving → draining*), evict the weights once idle, and return
  reserve-born executors to the cold pool.

Hysteresis (per-model cooldowns + a sustained-idle requirement) prevents
thrash under steady load.  The same policy object runs in both planes —
the simulation plane's analytic load times and the executable plane's
measured ones both flow through the coordinator's event loop.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.executor import (
    DRAINING,
    RESERVE,
    SERVING,
    WARMING,
    Executor,
)
from repro_torch.core.profiles import ProfileStore


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Knobs for the per-model scaling policy."""

    tick_interval: float = 0.5        # s between control-loop evaluations
    window: float = 10.0              # s of demand history per model
    # scale-up: queue pressure = ready nodes per warm executor
    up_queue_per_warm: float = 2.0    # depth/warm ratio that triggers growth
    up_delay_headroom: float = 0.35   # head wait > this fraction of SLO headroom
    # scale-down: sustained idleness
    down_idle_seconds: float = 6.0    # model must be queue-idle this long
    down_util_below: float = 0.15     # window-mean busy fraction of its group
    # hysteresis
    up_cooldown: float = 1.0          # s between scale-ups of one model
    down_cooldown: float = 8.0        # s between scale-downs of one model
    provision_delay: float = 0.1      # s to acquire a device before warming
    min_warm_per_model: int = 0       # floor of warm executors per seen model
    max_warm_per_model: Optional[int] = None   # cap (None = fleet size)
    max_up_per_tick: int = 2          # growth rate limit per model per tick


@dataclasses.dataclass
class ScaleAction:
    """One autoscaling decision, recorded in the coordinator's action log."""

    at: float
    kind: str                 # "scale_up" | "scale_down"
    model_id: str
    executor_id: int
    reason: str


class _ModelWindow:
    """Sliding-window demand samples for one model."""

    __slots__ = ("samples", "last_nonempty", "last_up", "last_down", "seen_at")

    def __init__(self, now: float) -> None:
        # (t, queue_depth, head_wait, group_busy_frac)
        self.samples: Deque[Tuple[float, int, float, float]] = deque()
        self.last_nonempty = now      # last time the model had queued work
        self.last_up = -1e9
        self.last_down = -1e9
        self.seen_at = now

    def add(self, t: float, depth: int, wait: float, busy: float,
            window: float) -> None:
        self.samples.append((t, depth, wait, busy))
        if depth > 0:
            self.last_nonempty = t
        horizon = t - window
        while self.samples and self.samples[0][0] < horizon:
            self.samples.popleft()

    def mean_busy(self) -> float:
        if not self.samples:
            return 0.0
        return sum(s[3] for s in self.samples) / len(self.samples)


class Autoscaler:
    """Per-model scale-up/scale-down policy over the executor fleet."""

    def __init__(self, profiles: ProfileStore,
                 config: Optional[AutoscalerConfig] = None) -> None:
        self.profiles = profiles
        self.config = config or AutoscalerConfig()
        self.windows: Dict[str, _ModelWindow] = {}
        self.actions: List[ScaleAction] = []
        # (t, model_ids) of admission-rejected requests: when the admission
        # controller sheds load, demand never reaches the ready queue, so
        # rejections ARE the demand signal (attributed to the request's
        # constituent models, weighted by their serial seconds)
        self.rejections: Deque[Tuple[float, Tuple[str, ...]]] = deque()
        self.n_quarantine_signals: int = 0
        self.n_worker_death_signals: int = 0

    def note_rejection(self, now: float, model_ids: Sequence[str]) -> None:
        self.rejections.append((now, tuple(model_ids)))

    def note_quarantine(self, now: float, model_ids: Sequence[str]) -> None:
        """A flapping executor was drained (chaos plane): the models it
        served lost capacity without their queues shrinking.  Feed the
        drained residents into the rejection-pressure window so the next
        tick re-provisions the group on healthy/reserve executors."""
        if model_ids:
            self.rejections.append((now, tuple(model_ids)))
            self.n_quarantine_signals += 1

    def note_worker_death(self, now: float, model_ids: Sequence[str]) -> None:
        """A worker *process* died (heartbeat lease expiry or exit on the
        process-isolated plane): its resident models lost capacity exactly
        like a quarantine drain — same demand signal, same window."""
        if model_ids:
            self.rejections.append((now, tuple(model_ids)))
            self.n_worker_death_signals += 1

    def _rejection_pressure(self, now: float) -> Dict[str, float]:
        """Serial-seconds of rejected work per model over the window."""
        horizon = now - self.config.window
        while self.rejections and self.rejections[0][0] < horizon:
            self.rejections.popleft()
        pressure: Dict[str, float] = {}
        for _, mids in self.rejections:
            for mid in mids:
                w = self.profiles.get(mid).infer_time(1, 1) \
                    if self.profiles.known(mid) else 0.0
                pressure[mid] = pressure.get(mid, 0.0) + w
        return pressure

    # ------------------------------------------------------------- signals
    def observe(
        self,
        now: float,
        ready: Sequence[Any],
        executors: Sequence[Executor],
    ) -> Dict[str, int]:
        """Record one demand sample per model; returns the per-model
        ready-queue depth so callers don't rescan the queue."""
        depth: Dict[str, int] = {}
        head_wait: Dict[str, float] = {}
        for rn in ready:
            mid = rn.model_id
            depth[mid] = depth.get(mid, 0) + 1
            since = getattr(rn, "ready_since", None)
            if since is not None:
                head_wait[mid] = max(head_wait.get(mid, 0.0), now - since)
        # model state table view: who is warm, who is busy
        group_n: Dict[str, int] = {}
        group_busy: Dict[str, int] = {}
        for e in executors:
            if not e.alive or e.state not in (SERVING, WARMING, DRAINING):
                continue
            for mid in e.loaded:
                group_n[mid] = group_n.get(mid, 0) + 1
                if e.busy_until > now:
                    group_busy[mid] = group_busy.get(mid, 0) + 1
            if e.state == WARMING and e.warming_model is not None:
                group_n[e.warming_model] = group_n.get(e.warming_model, 0) + 1
        for mid in set(depth) | set(group_n) | set(self.windows):
            w = self.windows.get(mid)
            if w is None:
                w = self.windows[mid] = _ModelWindow(now)
            n = group_n.get(mid, 0)
            busy = group_busy.get(mid, 0) / n if n else 0.0
            w.add(now, depth.get(mid, 0), head_wait.get(mid, 0.0), busy,
                  self.config.window)
        return depth

    # ------------------------------------------------------------ decisions
    def decide(
        self,
        now: float,
        ready: Sequence[Any],
        executors: Sequence[Executor],
    ) -> List[ScaleAction]:
        """Evaluate every tracked model; return the actions to apply."""
        cfg = self.config
        depth = self.observe(now, ready, executors)
        actions: List[ScaleAction] = []
        rej = self._rejection_pressure(now)

        headroom_frac: Dict[str, float] = {}
        for rn in ready:
            mid = rn.model_id
            since = getattr(rn, "ready_since", None)
            deadline = getattr(rn.request, "deadline", None)
            slo = getattr(rn.request, "slo_seconds", None)
            if since is not None and deadline is not None and slo:
                waited = now - since
                headroom = max(1e-9, deadline - since)
                headroom_frac[mid] = max(headroom_frac.get(mid, 0.0),
                                         waited / headroom)

        # capacity that serves now or will after warm-up; DRAINING is on
        # its way OUT and must not suppress a scale-up of its own model
        warm: Dict[str, List[Executor]] = {}
        for e in executors:
            if not e.alive:
                continue
            if e.state == WARMING and e.warming_model is not None:
                warm.setdefault(e.warming_model, []).append(e)
            elif e.state == SERVING:
                for mid in e.loaded:
                    warm.setdefault(mid, []).append(e)

        taken: set = set()
        # mid as final key: deterministic order under hash randomization
        for mid in sorted(set(depth) | set(self.windows) | set(rej),
                          key=lambda m: (-depth.get(m, 0), -rej.get(m, 0.0), m)):
            w = self.windows.get(mid)
            if w is None:
                w = self.windows[mid] = _ModelWindow(now)
            n_warm = len(warm.get(mid, []))
            d = depth.get(mid, 0)
            # ---- scale up
            pressure = d > cfg.up_queue_per_warm * max(1, n_warm) or (
                n_warm == 0 and d > 0)
            delayed = headroom_frac.get(mid, 0.0) > cfg.up_delay_headroom
            # admission shed work this model would have done: demand the
            # ready queue never sees, heaviest models first
            shedding = rej.get(mid, 0.0) > 0.0
            if shedding:
                w.last_nonempty = now
            if (pressure or delayed or shedding) and \
                    now - w.last_up >= cfg.up_cooldown:
                cap = len(executors) if cfg.max_warm_per_model is None \
                    else cfg.max_warm_per_model
                grown = 0
                while (n_warm + grown < cap and grown < cfg.max_up_per_tick
                       and (pressure or shedding or (delayed and grown == 0))):
                    target = self._pick_up_target(mid, executors, taken, now)
                    if target is None:
                        break
                    taken.add(target.id)
                    grown += 1
                    actions.append(ScaleAction(
                        now, "scale_up", mid, target.id,
                        f"depth={d} warm={n_warm} shed={rej.get(mid, 0.0):.1f}s "
                        f"delay_frac={headroom_frac.get(mid, 0.0):.2f}"))
                    pressure = d > cfg.up_queue_per_warm * max(1, n_warm + grown)
                if grown:
                    w.last_up = now
                continue
            # ---- scale down
            idle_for = now - w.last_nonempty
            if (d == 0
                    and n_warm > cfg.min_warm_per_model
                    and idle_for >= cfg.down_idle_seconds
                    and w.mean_busy() <= cfg.down_util_below
                    and now - w.last_down >= cfg.down_cooldown
                    and now - w.last_up >= cfg.down_idle_seconds):
                target = self._pick_down_target(mid, warm.get(mid, []), taken, now)
                if target is not None:
                    taken.add(target.id)
                    w.last_down = now
                    actions.append(ScaleAction(
                        now, "scale_down", mid, target.id,
                        f"idle={idle_for:.1f}s busy={w.mean_busy():.2f}"))
        self.actions.extend(actions)
        return actions

    # ------------------------------------------------------------- targets
    def _pick_up_target(
        self, model_id: str, executors: Sequence[Executor],
        taken: set, now: float,
    ) -> Optional[Executor]:
        """Best executor to warm ``model_id`` on: an idle serving executor
        without the model first (re-targeting), then a cold reserve one."""
        profile = self.profiles.get(model_id) if self.profiles.known(model_id) \
            else None
        need = profile.param_bytes if profile else 0.0
        idle = [
            e for e in executors
            if e.alive and e.id not in taken and e.state == SERVING
            and not e.has_model(model_id) and e.is_free(now)
            and not e.assigned_models        # don't steal another group's exec
        ]
        if idle:
            # prefer one that can fit without evicting
            idle.sort(key=lambda e: (0 if e.can_fit(need) else 1, e.id))
            return idle[0]
        reserve = [e for e in executors
                   if e.alive and e.id not in taken and e.state == RESERVE]
        if reserve:
            return min(reserve, key=lambda e: e.id)
        return None

    def _pick_down_target(
        self, model_id: str, group: Sequence[Executor],
        taken: set, now: float,
    ) -> Optional[Executor]:
        """Retire the least-useful group member.  Only executors this
        autoscaler assigned to the model are candidates — the organically
        warm fleet is the Scheduler's (LRU) business, and evicting it
        would thrash.  Reserve-born executors retire first (give the
        device back), then multi-model residents."""
        cands = [e for e in group
                 if e.id not in taken and e.state == SERVING
                 and model_id in e.assigned_models]
        if not cands:
            return None
        cands.sort(key=lambda e: (0 if e.reserve_born else 1,
                                  -len(e.loaded), e.id))
        return cands[0]

    # -------------------------------------------------------------- metrics
    def n_actions(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return len(self.actions)
        return sum(1 for a in self.actions if a.kind == kind)
