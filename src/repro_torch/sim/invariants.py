"""Serving-system invariants checked after (or during) chaos runs.

The chaos plane (:mod:`repro_torch.core.faults`) injects crashes, hangs,
transient errors and lost transfers; the hardening in the coordinator is
supposed to absorb all of them without violating the runtime's core
contracts.  :func:`check_invariants` states those contracts once, as
code, and returns every violation it finds:

1.  **Exactly-once termination** — every request the coordinator ever
    admitted ends in exactly one of *finished*, *rejected* or *shed*;
    after a drained ``run()`` nothing is left inflight, no terminal list
    shares a request with another, and the terminal lists account for
    every submission that arrived.
2.  **No duplicated commits** — immutable values are committed once: the
    data engine's ``duplicate_puts`` counter stays zero even when
    lineage recovery re-executes producers.
3.  **Refcounts never go negative** — ``min_refcount_seen`` (a watermark
    maintained by :meth:`DataEngine.release`) stays >= 0.
4.  **No leaked values** — once a request leaves the system, the only
    keys of it still in the store are the pinned workflow outputs of
    *finished* requests (shed/rejected requests leave nothing).
5.  **Finished means finished** — a finished request has ``remaining ==
    0``, every non-inline node DONE, a completion time no earlier than
    its arrival, and (executable plane) a live value for every workflow
    output.
6.  **Lineage replay terminated** — no node is left mid-flight
    (RUNNING/AWAITING) and the ready queue is empty once the event loop
    drains.
7.  **Transport accounting closes** (process-isolated plane only) —
    every exec reply the coordinator accepted was either applied or
    provably fenced (``n_exec_replies == n_exec_applied + n_fenced``),
    no frame survived a checksum mismatch, and the datastore's staging
    views only name executors that exist.

These checks are cheap (linear in requests + store size) and pure —
they never mutate the coordinator — so chaos tests and
``bench_chaos.py`` run them after every scenario.
"""

from __future__ import annotations

from typing import Any, List

__all__ = ["check_invariants", "assert_invariants"]


def check_invariants(coordinator: Any, drained: bool = True) -> List[str]:
    """Return a list of human-readable invariant violations (empty when
    the system is consistent).  ``drained=False`` relaxes the checks
    that only hold after a run-to-completion (empty inflight/ready)."""
    errs: List[str] = []
    co = coordinator
    eng = co.engine

    finished = {r.rid for r in co.finished}
    rejected = {r.rid for r in co.rejected}
    shed = {r.rid for r in getattr(co, "shed", [])}

    # 1. exactly-once termination ---------------------------------------
    for a, b, name in (
        (finished, rejected, "finished∩rejected"),
        (finished, shed, "finished∩shed"),
        (rejected, shed, "rejected∩shed"),
    ):
        both = a & b
        if both:
            errs.append(f"requests terminated twice ({name}): {sorted(both)}")
    if len(finished) != len(co.finished):
        errs.append("finished list holds duplicate requests")
    if len(rejected) != len(co.rejected):
        errs.append("rejected list holds duplicate requests")
    if len(shed) != len(getattr(co, "shed", [])):
        errs.append("shed list holds duplicate requests")
    for r in co.finished:
        if r.status != "done":
            errs.append(f"request {r.rid} in finished with status {r.status!r}")
    for r in getattr(co, "shed", []):
        if r.status != "shed":
            errs.append(f"request {r.rid} in shed with status {r.status!r}")
    if drained:
        if co.inflight:
            errs.append(f"inflight not empty after drain: {sorted(co.inflight)}")
        terminated = len(finished) + len(rejected) + len(shed)
        n_submitted = getattr(co, "n_submitted", None)
        if n_submitted is not None and terminated > n_submitted:
            errs.append(
                f"{terminated} terminations for {n_submitted} submissions")
        if n_submitted is not None and terminated + len(co.inflight) < n_submitted \
                and not co.events:
            errs.append(
                f"{n_submitted} submissions but only {terminated} terminations "
                "after the event loop drained (request lost without a trace)")

    # 2./3. data-engine counters ----------------------------------------
    if eng.duplicate_puts:
        errs.append(f"{eng.duplicate_puts} duplicate commit(s) of a live key")
    if eng.min_refcount_seen < 0:
        errs.append(f"refcount went negative (min {eng.min_refcount_seen})")

    # 4. no leaked values ------------------------------------------------
    live_ok = set()
    for r in co.finished:
        live_ok |= r.pinned_keys
    for r in co.inflight.values():   # inflight may hold anything of its own
        live_ok |= {k for k in _request_keys(r)}
    leaked = []
    for key in _store_keys(eng):
        if key not in live_ok:
            leaked.append(key)
    if drained and leaked:
        errs.append(f"{len(leaked)} leaked value(s), e.g. {sorted(leaked)[:5]}")

    # 5. finished means finished ----------------------------------------
    for r in co.finished:
        if r.remaining != 0:
            errs.append(f"finished request {r.rid} has remaining={r.remaining}")
        if r.completion is None or r.completion < r.arrival:
            errs.append(
                f"finished request {r.rid} completion {r.completion} "
                f"before arrival {r.arrival}")
        not_done = [rn.uid for rn in r.nodes.values() if rn.state != "done"]
        if not_done:
            errs.append(f"finished request {r.rid} has non-DONE nodes {not_done}")
        if co.backend is not None:
            for name, ref in r.graph.outputs.items():
                if not eng.exists(r.ref_key(ref)):
                    errs.append(
                        f"finished request {r.rid} lost output {name!r}")

    # 6. replay terminated ----------------------------------------------
    if drained:
        if co.ready:
            errs.append(f"{len(co.ready)} node(s) stuck in the ready queue")
        for r in co.inflight.values():
            for rn in r.nodes.values():
                if rn.state in ("running", "awaiting"):
                    errs.append(f"node {rn.uid} left mid-flight ({rn.state})")

    # 7. transport accounting closes (process plane) ---------------------
    be = co.backend
    if be is not None and getattr(be, "is_proc_plane", False):
        if be.crc_errors:
            errs.append(f"{be.crc_errors} frame checksum error(s) on the wire")
        if be.n_exec_replies != be.n_exec_applied + be.n_fenced:
            errs.append(
                f"exec replies unaccounted: {be.n_exec_replies} received != "
                f"{be.n_exec_applied} applied + {be.n_fenced} fenced")
        for eid in getattr(eng, "staged", {}):
            if eid not in co.by_id:
                errs.append(f"staging view for unknown executor {eid}")
    return errs


def assert_invariants(coordinator: Any, drained: bool = True) -> None:
    """Raise ``AssertionError`` listing every violated invariant."""
    errs = check_invariants(coordinator, drained=drained)
    assert not errs, "invariant violations:\n  " + "\n  ".join(errs)


def _request_keys(req: Any) -> List[str]:
    keys = [f"r{req.rid}:in:{name}" for name in req.graph.input_ports]
    for n in req.graph.nodes:
        keys.extend(req.ref_key(ref) for ref in n.output_refs.values())
    for rn in req.nodes.values():
        if getattr(rn, "seg_commit", None) is not None:
            keys.append(rn.seg_commit[0])
    return keys


def _store_keys(engine: Any) -> List[str]:
    return list(engine._store.keys())
