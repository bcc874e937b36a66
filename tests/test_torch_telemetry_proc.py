"""Cross-process trace stitching on the port's process-isolated executor
plane: the cases of ``tests/test_telemetry_proc.py`` restated for
``ProcBackend(device="cpu")``, each served image held bit for bit against
the port's in-process plane.

The span context rides the exec RPC, so worker-side stage/forward spans
land on the worker's pid track rebased onto the coordinator's virtual
dispatch time, and request flows span the process boundary.  Chaos runs
prove the hard part: a worker declared dead mid-RPC leaves ONE stitched
trace where the pre-death worker spans, the fenced zombie reply, and the
recovery re-dispatch all share the request's trace id.

Skips only where the host cannot spawn processes.
"""

import pytest
import torch

from repro_torch.core import (
    FaultPlane,
    LocalBackend,
    ProcBackend,
    ProcConfig,
    Scheduler,
    ServingSystem,
    processes_available,
)
from repro_torch.core.telemetry import (
    MetricsRegistry,
    configure,
    validate_chrome_trace,
)
from repro_torch.diffusion import make_basic_workflow

FAST = ProcConfig(hb_interval=0.02, hb_timeout=2.0, spawn_timeout=60.0,
                  exec_wall_timeout=60.0)


@pytest.fixture(scope="module")
def spawnable():
    if not processes_available():
        pytest.skip("the host forbids spawning worker processes")


@pytest.fixture(scope="module")
def tele_on():
    prev = configure(True)
    yield
    configure(prev)


def _serve(wf, inputs, steps=5, faults=None, config=FAST, n_exec=2,
           backend=None):
    backend = (backend if backend is not None
               else ProcBackend(config, device="cpu"))
    sys_ = ServingSystem(n_executors=n_exec, backend=backend,
                         faults=faults, metrics=MetricsRegistry())
    sys_.coordinator.scheduler = Scheduler(
        sys_.profiles, use_declared_max_batch=True, segment_chunk=2)
    sys_.register(wf)
    req = sys_.submit(wf.name, inputs=inputs, arrival=0.0, steps=steps)
    return sys_, req


def _image(sys_, req):
    assert req.status == "done", req.status
    return sys_.coordinator.engine.value_of(
        req.ref_key(req.graph.outputs["image"]))


def _local_image(inputs):
    sys_, req = _serve(make_basic_workflow("sd3"), inputs,
                       backend=LocalBackend(device="cpu"))
    sys_.run()
    return _image(sys_, req)


def _proc_segment_exec_indices(backend):
    return [i for i, (model_id, _) in enumerate(backend.exec_log)
            if model_id.startswith("segment:")]


@pytest.fixture(scope="module")
def traced_run(spawnable, tele_on):
    """The basic request on a traced proc system (closed afterwards)."""
    sys_, req = _serve(make_basic_workflow("sd3"),
                       {"seed": 0, "prompt": "a fox"})
    with sys_:
        sys_.run()
    return sys_, req


def test_proc_trace_stitches_across_pids(traced_run, tmp_path):
    sys_, req = traced_run
    assert req.status == "done"
    torch.testing.assert_close(
        _image(sys_, req), _local_image({"seed": 0, "prompt": "a fox"}),
        rtol=0, atol=0)
    p = tmp_path / "proc_trace.json"
    sys_.export_trace(str(p))
    stats = validate_chrome_trace(str(p), expect_multi_pid=True)
    assert stats["n_pids"] >= 2                 # coordinator + worker(s)
    assert stats["n_multi_pid_flows"] >= 1      # request crosses the boundary
    tr = sys_.tracer
    worker = [e for e in tr.events if e["ph"] == "X" and e["tid"] == "worker"]
    assert any(e["name"].startswith("forward") for e in worker)
    assert any(e["name"] == "stage" for e in worker)
    # worker spans carry the request's trace id (stitched, not orphaned)
    assert all(e["trace"] == req.rid for e in worker)
    # heartbeat instants surfaced from the frame channel
    assert any(e["ph"] == "i" and e["name"] == "hb" for e in tr.events)
    # prometheus dump sees through to the proc-plane counters
    txt = sys_.metrics_text()
    assert "backend_n_exec_applied" in txt
    assert "backend_worker_seconds" in txt


def test_zombie_blackhole_trace_is_stitched(spawnable, tele_on, tmp_path):
    """The acceptance scenario: a worker partitioned mid-RPC past the
    liveness lease keeps computing, is declared dead, and its late
    ``exec_done`` is fenced.  The exported trace must show the pre-death
    worker spans, the fenced zombie reply (orphaned-but-attributed spans
    on the ``fenced`` track), and the recovery re-dispatch sharing ONE
    request trace id — and still validate as a well-formed timeline."""
    wf = make_basic_workflow("sd3")
    cfg = ProcConfig(hb_interval=0.02, hb_timeout=0.25, spawn_timeout=60.0,
                     exec_wall_timeout=60.0)
    faults = FaultPlane(seed=0, blackhole_exec=5, blackhole_seconds=0.45)
    sys_, req1 = _serve(wf, {"seed": 0, "prompt": "a"}, faults=faults,
                        config=cfg)
    with sys_:
        sys_.run()
        assert req1.status == "done"
        req2 = sys_.submit(wf.name, inputs={"seed": 1, "prompt": "b"},
                           arrival=sys_.coordinator.now, steps=5)
        sys_.run()
    co = sys_.coordinator
    assert req2.status == "done"
    assert co.n_heartbeat_deaths >= 1
    assert co.backend.n_fenced >= 1
    for req, inputs in ((req1, {"seed": 0, "prompt": "a"}),
                        (req2, {"seed": 1, "prompt": "b"})):
        torch.testing.assert_close(_image(sys_, req), _local_image(inputs),
                                   rtol=0, atol=0)
    tr = sys_.tracer
    # the fenced reply surfaced as an instant + spans on the fenced track
    fenced_i = [e for e in tr.events
                if e["ph"] == "i" and e["name"] == "fenced_reply"]
    assert fenced_i, "fenced zombie reply must appear on the timeline"
    rid = fenced_i[0]["trace"]
    assert rid is not None
    fenced_spans = [e for e in tr.events
                    if e["ph"] == "X" and e["tid"] == "fenced"]
    assert fenced_spans, "zombie's worker spans must be recorded"
    assert all(e["trace"] == rid for e in fenced_spans)
    assert all(e["args"]["fenced"] for e in fenced_spans)
    # pre-death worker spans of the same request trace
    pre = [e for e in tr.events if e["ph"] == "X"
           and e["tid"] == "worker" and e["trace"] == rid]
    assert pre, "pre-death spans must share the request's trace id"
    # the worker-death + recovery re-dispatch, same trace id
    deaths = [e for e in tr.events
              if e["ph"] == "i" and e["name"] == "worker_death"]
    assert deaths
    recov = [e for e in tr.events if e["ph"] == "i"
             and e["name"] in ("requeue", "replay") and e["trace"] == rid]
    assert recov, "recovery must be attributed to the same trace id"
    # and the whole chaotic timeline still validates
    p = tmp_path / "zombie_trace.json"
    sys_.export_trace(str(p))
    validate_chrome_trace(str(p), expect_multi_pid=True)


def test_kill_midsegment_trace_validates(traced_run, tmp_path):
    """kill -9 right after a mid-segment exec frame hits the wire: the
    respawn + replay path must leave a well-formed trace where the
    recovery is attributed to the interrupted request."""
    ref_sys, ref_req = traced_run
    assert ref_req.status == "done"
    seg_idxs = _proc_segment_exec_indices(ref_sys.coordinator.backend)
    assert len(seg_idxs) >= 2

    wf = make_basic_workflow("sd3")
    faults = FaultPlane(seed=0, kill_every_execs=seg_idxs[1], max_kills=1)
    sys_, req = _serve(wf, {"seed": 0, "prompt": "a fox"}, faults=faults)
    with sys_:
        sys_.run()
    assert req.status == "done"
    assert faults.n_kills == 1
    torch.testing.assert_close(_image(sys_, req), _image(ref_sys, ref_req),
                               rtol=0, atol=0)
    tr = sys_.tracer
    deaths = [e for e in tr.events
              if e["ph"] == "i" and e["name"] == "worker_death"]
    assert deaths
    recov = [e for e in tr.events if e["ph"] == "i"
             and e["name"] in ("requeue", "replay")
             and e["trace"] == req.rid]
    assert recov
    pre = [e for e in tr.events if e["ph"] == "X"
           and e["tid"] == "worker" and e["trace"] == req.rid]
    assert pre, "spans from before the kill must carry the trace id"
    p = tmp_path / "kill_trace.json"
    sys_.export_trace(str(p))
    validate_chrome_trace(str(p), expect_multi_pid=True)
