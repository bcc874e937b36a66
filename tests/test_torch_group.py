"""The port's multi-coordinator sharding (``repro_torch.core.group``)
against the JAX package's: ``cluster_workflows`` gives the same
partitions for every Table 2 setting, and ``CoordinatorGroup`` on the same
trace the same routes, coordinators, finished counts and SLO attainment
(the simulation plane; no tolerance: equality).  Then the three cases of
``tests/test_group.py`` on the port."""

import pytest

import repro.core as jcore
import repro.diffusion as jdiff
import repro.sim as jsim
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
import repro_torch.sim as tsim

PACKAGES = {"jax": (jcore, jdiff, jsim), "torch": (tcore, tdiff, tsim)}
SETTINGS = ["s1", "s2", "s3", "s4", "s5", "s6"]


def _partitions(package, setting):
    core, diff, _ = PACKAGES[package]
    probe = core.ServingSystem(n_executors=1)
    wfs = diff.table2_setting(setting)

    def compile_graph(tmpl):
        probe.register(tmpl)
        return probe.registry.instantiate(tmpl.name)

    return core.cluster_workflows(wfs, compile_graph)


@pytest.mark.parametrize("setting", SETTINGS)
def test_cluster_workflows_equals_reference(setting):
    assert _partitions("torch", setting) == _partitions("jax", setting)


def _serve(package, setting, n_executors, max_coordinators, rate, seed):
    core, diff, sim = PACKAGES[package]
    wfs = diff.table2_setting(setting)
    group = core.CoordinatorGroup(wfs, n_executors=n_executors,
                                  max_coordinators=max_coordinators)
    trace = sim.generate_trace(list(wfs), rate=rate, duration=120, cv=1.5,
                               seed=seed)
    for t in trace:
        group.submit(t.workflow, inputs=t.inputs, arrival=t.arrival,
                     slo_seconds=30.0)
    group.run()
    return {
        "n_coordinators": group.n_coordinators,
        "route": group.route,
        "executors": [len(s.executors) for s in group.systems],
        "finished": [len(s.coordinator.finished) for s in group.systems],
        "rejected": [len(s.coordinator.rejected) for s in group.systems],
        "slo_attainment": group.slo_attainment(),
        "busy": group.total_busy_time(),
        "n_trace": len(trace),
    }


@pytest.mark.parametrize("setting,n_executors,max_coordinators,rate,seed", [
    ("s5", 8, 4, 0.5, 2),       # tests/test_group.py's trace
    ("s6", 6, 2, 1.0, 5),
    ("s1", 4, 4, 1.5, 0),       # one cluster, one coordinator
])
def test_coordinator_group_equals_reference(setting, n_executors,
                                            max_coordinators, rate, seed):
    args = (setting, n_executors, max_coordinators, rate, seed)
    got, want = _serve("torch", *args), _serve("jax", *args)
    assert got == want
    assert sum(got["finished"]) + sum(got["rejected"]) == got["n_trace"]


def test_clusters_preserve_sharing():
    wfs = tdiff.table2_setting("s5")
    group = tcore.CoordinatorGroup(wfs, n_executors=8, max_coordinators=4)
    assert group.n_coordinators == 2
    sd3 = {group.route[n] for n in wfs if n.startswith("sd3:")}
    sd35 = {group.route[n] for n in wfs if n.startswith("sd3.5-large:")}
    assert len(sd3) == 1 and len(sd35) == 1 and sd3 != sd35


def test_group_serves_trace():
    got = _serve("torch", "s5", 8, 4, 0.5, 2)
    assert sum(got["finished"]) + sum(got["rejected"]) == got["n_trace"]
    assert got["slo_attainment"] > 0.3


def test_single_cluster_single_coordinator():
    group = tcore.CoordinatorGroup(tdiff.table2_setting("s1"), n_executors=4)
    assert group.n_coordinators == 1
