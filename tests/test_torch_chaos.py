"""The port's coordinator under crash-and-revive fault schedules: every
request terminates exactly once, checked with the port's serving-system
invariants (``repro_torch.sim.check_invariants``) on the same toy
workflow; those invariants give the reference package's findings on the
same coordinator.

The property tests are those of ``tests/test_chaos_props.py`` and
``tests/test_substrate.py``'s failure-schedule property, run against the
port with a fixed sweep (``derandomize=True``) and no example database, so
that neither a random draw nor a saved example decides the outcome."""

import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import repro.sim as jsim
import repro_torch.core as tcore
from repro_torch.sim import assert_invariants, check_invariants

FIXED_SWEEP = settings(derandomize=True, database=None, max_examples=10,
                       deadline=None,
                       suppress_health_check=[HealthCheck.too_slow])


class _ToyModel(tcore.Model):
    """Sim-plane model with no real compute."""

    def __init__(self, model_id, inputs, outputs, cost_kw=None, trivial=False,
                 deferred=()):
        self._io = (inputs, outputs, set(deferred))
        self._cost_kw = cost_kw or {}
        self.trivial = trivial
        super().__init__(model_id=model_id)

    def setup_io(self):
        inputs, outputs, deferred = self._io
        for name, typ in inputs:
            self.add_input(name, typ, deferred=name in deferred)
        for name, typ in outputs:
            self.add_output(name, typ)

    def execute(self, model_components, **kw):
        return {name: f"<{self.model_id}.{name}>" for name, _ in self._io[1]}

    def cost(self):
        kw = dict(flops_per_item=1e13, param_bytes=2e9, act_io_bytes=1e9,
                  output_bytes=4e6, max_batch=8, max_parallelism=1)
        kw.update(self._cost_kw)
        return tcore.ModelCost(**kw)


def _toy_workflow(steps=4):
    T = tcore.TensorType()
    enc = _ToyModel("enc", [("prompt", str)], [("emb", T)],
                    {"flops_per_item": 1e11, "max_batch": 8})
    backbone = _ToyModel(
        "backbone", [("latents", T), ("emb", T), ("cn", T)], [("noise", T)],
        {"flops_per_item": 5e13, "param_bytes": 4e9, "max_parallelism": 2,
         "max_batch": 4},
        deferred=("cn",))
    cn = _ToyModel("cn", [("latents", T), ("emb", T)], [("res", T)],
                   {"flops_per_item": 2.5e13, "output_bytes": 1.5e8,
                    "max_batch": 4})
    denoise = _ToyModel("denoise", [("noise", T), ("latents", T)],
                        [("latents", T)],
                        {"flops_per_item": 1e6, "param_bytes": 0}, trivial=True)
    latgen = _ToyModel("latgen", [("seed", int)], [("latents", T)],
                       {"flops_per_item": 1e6, "param_bytes": 0}, trivial=True)
    vae = _ToyModel("vae", [("latents", T)], [("img", T)],
                    {"flops_per_item": 5e12, "param_bytes": 3e8})

    @tcore.compose("toy_chaos")
    def wf_fn(wf):
        seed = wf.add_input("seed", int)
        prompt = wf.add_input("prompt", str)
        lat = latgen(seed)
        emb = enc(prompt)
        for _ in range(steps):
            res = cn(lat, emb)
            noise = backbone(lat, emb, cn=res)
            lat = denoise(noise, lat)
        img = vae(lat)
        wf.add_output(img, name="img")

    return wf_fn


def _toy_cn_workflow():
    """``tests/conftest.py``'s ``toy_cn`` workflow on the port: the step
    count comes from ``submit``."""
    T = tcore.TensorType()
    enc = _ToyModel("enc", [("prompt", str)], [("emb", T)],
                    {"flops_per_item": 1e11, "param_bytes": 2e9, "max_batch": 8})
    backbone = _ToyModel(
        "backbone", [("latents", T), ("emb", T), ("cn", T)], [("noise", T)],
        {"flops_per_item": 5e13, "param_bytes": 4e9, "max_parallelism": 2,
         "max_batch": 4},
        deferred=("cn",))
    cn = _ToyModel("cn", [("latents", T), ("emb", T)], [("res", T)],
                   {"flops_per_item": 2.5e13, "param_bytes": 2e9,
                    "output_bytes": 1.5e8, "max_batch": 4})
    denoise = _ToyModel("denoise", [("noise", T), ("latents", T)],
                        [("latents", T)],
                        {"flops_per_item": 1e6, "param_bytes": 0}, trivial=True)
    latgen = _ToyModel("latgen", [("seed", int)], [("latents", T)],
                       {"flops_per_item": 1e6, "param_bytes": 0}, trivial=True)
    vae = _ToyModel("vae", [("latents", T)], [("img", T)],
                    {"flops_per_item": 5e12, "param_bytes": 3e8})

    @tcore.compose("toy_cn")
    def wf_fn(wf, steps=6):
        seed = wf.add_input("seed", int)
        prompt = wf.add_input("prompt", str)
        lat = latgen(seed)
        emb = enc(prompt)
        for _ in range(steps):
            res = cn(lat, emb)
            noise = backbone(lat, emb, cn=res)
            lat = denoise(noise, lat)
        img = vae(lat)
        wf.add_output(img, name="img")

    return wf_fn


def _run_failures(fail_times):
    """4 executors, 4 requests at i * 0.2 s, 4 steps; executor i % 3 fails
    at each of ``fail_times`` (one executor always survives)."""
    sys_ = tcore.ServingSystem(n_executors=4)
    sys_.register(_toy_cn_workflow())
    reqs = [sys_.submit("toy_cn", inputs={"seed": i, "prompt": "x"},
                        arrival=i * 0.2, steps=4) for i in range(4)]
    for i, t in enumerate(fail_times):
        sys_.coordinator.fail_executor(i % 3, at=float(t))
    sys_.run()
    return sys_, reqs


def test_lineage_recovery_readies_a_node_whose_input_came_back_inline():
    """The schedule that stranded request 2: recovery re-executes its
    backbone, whose lost latents input is restored at once by the inline
    ``latgen``; the backbone must then be readied, not left PENDING with
    no input outstanding."""
    sys_, reqs = _run_failures([1.25, 0.5, 0.28125])
    co = sys_.coordinator
    assert [r.status for r in reqs] == ["done"] * 4
    assert not check_invariants(co)
    assert not co.inflight


@given(st.lists(st.floats(0.05, 2.0), min_size=1, max_size=3, unique=True))
@FIXED_SWEEP
def test_requests_survive_any_failure_schedule(fail_times):
    """Whatever executors die mid-flight, lineage re-execution completes
    every admitted request (as long as one executor survives)."""
    sys_, reqs = _run_failures(fail_times)
    assert all(r.status == "done" for r in reqs)
    assert not check_invariants(sys_.coordinator)


def _run_chaos(faults, n_requests=6, n_executors=4, retry=None):
    sys_ = tcore.ServingSystem(n_executors=n_executors, faults=faults,
                               retry_policy=retry)
    sys_.register(_toy_workflow())
    reqs = [sys_.submit("toy_chaos", inputs={"seed": i, "prompt": "x"},
                        arrival=i * 0.15, slo_seconds=60.0)
            for i in range(n_requests)]
    sys_.run()
    return sys_, reqs


_FAULT_FIELDS = dict(
    seed=st.integers(0, 2**16),
    crash_every_batches=st.one_of(st.none(), st.integers(2, 9)),
    crash_p=st.floats(0.0, 0.15),
    revive_after=st.one_of(st.none(), st.floats(0.1, 2.0)),
    slow_p=st.floats(0.0, 0.2),
    slow_factor=st.floats(2.0, 12.0),
    hang_p=st.floats(0.0, 0.15),
    transient_p=st.floats(0.0, 0.3),
    fetch_loss_p=st.floats(0.0, 0.2),
    max_crashes=st.one_of(st.none(), st.integers(1, 6)),
    crash_frac=st.floats(0.05, 0.95),
)
fault_fields = st.fixed_dictionaries(_FAULT_FIELDS)


@given(fields=fault_fields)
@FIXED_SWEEP
def test_invariants_hold_under_any_fault_schedule(fields):
    sys_, reqs = _run_chaos(tcore.FaultPlane(**fields))
    errs = check_invariants(sys_.coordinator)
    assert not errs, f"faults={fields}: " + "; ".join(errs)
    for r in reqs:
        assert r.status in ("done", "rejected", "shed"), r.status


@given(fields=fault_fields)
@FIXED_SWEEP
def test_same_seed_replays_identically(fields):
    """The fault plane draws from (seed, site, counter) hashes only: two
    runs of the same configuration are identical."""

    def snapshot():
        faults = tcore.FaultPlane(**fields)
        sys_, reqs = _run_chaos(faults)
        co = sys_.coordinator
        return ([(r.rid, r.status, r.completion) for r in reqs],
                faults.counts(), co.n_timeouts, co.n_requeues,
                co.n_transient_retries, round(co.now, 9))

    assert snapshot() == snapshot()


@given(every=st.integers(2, 6), seed=st.integers(0, 99))
@FIXED_SWEEP
def test_crash_revive_cadence_completes_all_requests(every, seed):
    faults = tcore.FaultPlane(seed=seed, crash_every_batches=every,
                              revive_after=0.5)
    sys_, reqs = _run_chaos(faults)
    co = sys_.coordinator
    assert not check_invariants(co)
    assert all(r.status in ("done", "rejected", "shed") for r in reqs)
    assert len(co.finished) >= len(reqs) - len(co.rejected) - len(co.shed)


@given(seed=st.integers(0, 99))
@FIXED_SWEEP
def test_retry_budget_sheds_exactly_once(seed):
    """A forward that always hangs exhausts the retry budget: every request
    ends shed exactly once, and the store is left empty."""
    retry = tcore.RetryPolicy(node_retry_budget=2, backoff_base=0.01,
                              timeout_factor=2.0)
    sys_, reqs = _run_chaos(tcore.FaultPlane(seed=seed, hang_p=1.0),
                            n_requests=3, retry=retry)
    co = sys_.coordinator
    assert not check_invariants(co)
    assert len(co.shed) == len([r for r in reqs if r.status == "shed"])
    assert all(r.status == "shed" for r in reqs)
    assert co.n_timeouts > 0
    assert len(co.engine) == 0


@pytest.mark.parametrize("every", range(2, 10))
@pytest.mark.parametrize("revive_after", [0.5, 1.0])
def test_crash_revive_terminates_each_request_once(every, revive_after):
    """A crash every few batches re-runs work; a request whose last node
    completes inline must still finish exactly once."""
    faults = tcore.FaultPlane(seed=0, crash_every_batches=every,
                              revive_after=revive_after, crash_frac=0.25)
    sys_ = tcore.ServingSystem(n_executors=4, faults=faults)
    sys_.register(_toy_workflow())
    reqs = [sys_.submit("toy_chaos", inputs={"seed": i, "prompt": "x"},
                        arrival=i * 0.15, slo_seconds=60.0)
            for i in range(6)]
    sys_.run()
    co = sys_.coordinator
    assert not check_invariants(co)
    assert sorted(r.rid for r in co.finished) == sorted(
        r.rid for r in reqs if r.status == "done")
    assert all(r.status in ("done", "rejected", "shed") for r in reqs)


def _corrupt(co):
    """Break the coordinator's books the ways the invariants look for: a
    request finished twice and also shed, a leaked store key, a duplicate
    commit, a negative refcount and a node left mid-flight."""
    eng = co.engine
    done = co.finished[0]
    co.finished.append(done)
    co.shed.append(done)
    key = "r999:leak"
    eng.put(key, None, 8, value="<leak>")
    eng.duplicate_puts += 2
    eng.min_refcount_seen = -1
    done.remaining = 1
    next(iter(done.nodes.values())).state = "running"
    co.inflight[done.rid] = done


@pytest.mark.parametrize("seed,corrupt", [(3, False), (8, False), (3, True)],
                         ids=["seed3", "seed8", "seed3-corrupted"])
def test_invariants_match_the_reference_module(seed, corrupt):
    """After a chaos run (and after corrupting its books), the port's
    ``check_invariants`` returns the reference's list, drained or not."""
    faults = tcore.FaultPlane(seed=seed, crash_every_batches=3,
                              revive_after=0.5, transient_p=0.1,
                              fetch_loss_p=0.1)
    sys_, _ = _run_chaos(faults)
    co = sys_.coordinator
    if corrupt:
        _corrupt(co)
    for drained in (True, False):
        errs = check_invariants(co, drained=drained)
        assert errs == jsim.check_invariants(co, drained=drained)
        assert bool(errs) == corrupt
    if corrupt:
        assert len(check_invariants(co)) >= 6
        with pytest.raises(AssertionError, match="invariant violations"):
            assert_invariants(co)
    else:
        assert_invariants(co)
