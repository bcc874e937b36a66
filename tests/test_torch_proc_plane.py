"""The port's process-isolated executor plane on the CPU: the cases of
``tests/test_proc_plane.py`` restated for ``ProcBackend(device="cpu")``,
each held bit for bit against the port's in-process plane, plus the slice
against the JAX package.

Every test here drives REAL worker processes (multiprocessing spawn +
TCP frame transport):

* proc execution is bit-exact against ``LocalBackend(device="cpu")``, with
  the staging protocol avoiding re-ships of keyed tensors;
* SIGKILL mid-segment -> the supervisor respawns the worker and lineage
  replay reproduces the fault-free image bit-exactly (basic AND LoRA);
* a heartbeat blackhole partitions a worker long enough to be declared
  dead; the zombie is adopted, its late ``exec_done`` carries a stale
  epoch and is provably fenced, and the transport accounting invariant
  (replies == applied + fenced) closes;
* duplicated / reordered control frames are absorbed without breaking
  parity;
* the supervisor restart lifecycle bumps the fencing epoch and rotates
  the worker pid;
* decoded adapter factors ship once, then ride staged refs, and re-ship
  exactly what a killed worker lacks;
* the toy ``sd3:basic`` request on the JAX package's weights and latents
  lies within 1e-4 relative of the JAX package's in-process image (L2
  norm of the difference over the norm of the JAX image, as in
  ``tests/test_torch_serving.py``); the given weights cross once per
  worker incarnation, never inside an ``exec`` frame's op.

A worker computes with the parent's intra-op thread count, so its CPU
GEMMs give the in-process backend's bits.  Every system here is closed
(``with``), every spawn is bounded by ``spawn_timeout`` and every RPC by
``exec_wall_timeout``.  Skips only where the host cannot spawn processes.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.diffusion as jdiff
from repro_torch.core import (
    FaultPlane,
    GraphCompiler,
    LocalBackend,
    ProcBackend,
    ProcConfig,
    Scheduler,
    ServingSystem,
    processes_available,
)
from repro_torch.core import supervisor as sup
from repro_torch.core.passes import InlineTrivialPass, JitCompilePass, SegmentFusionPass
from repro_torch.core.profiles import GPU_H800
from repro_torch.core.registry import WorkflowRegistry
from repro_torch.core.transport import (
    HEADER_BYTES,
    FrameChannel,
    decode_value,
    encode_frame,
)
from repro_torch.diffusion import FAMILIES, ModelSet, make_basic_workflow, make_lora_workflow
from repro_torch.sim import assert_invariants, check_invariants
from repro_torch.weights import from_numpy

# adapter fetch resolves (sim-time) before any measured dispatch finishes
FAST_FETCH = dataclasses.replace(GPU_H800, remote_bw=1e18)

# short wall-clock knobs so liveness tests finish fast; the lease stays
# comfortably above one RPC's worth of silence, and no spawn or RPC can
# hold the suite for long
FAST = ProcConfig(hb_interval=0.02, hb_timeout=2.0, spawn_timeout=60.0,
                  exec_wall_timeout=60.0)
REQUESTS = [{"seed": 0, "prompt": "a fox"},
            {"seed": 1, "prompt": "two foxes in the snow"}]


@pytest.fixture(scope="module")
def spawnable():
    if not processes_available():
        pytest.skip("the host forbids spawning worker processes")


def _serve(wf, inputs, steps=5, faults=None, hw=GPU_H800, n_exec=2,
           config=FAST, backend=None):
    """One executable-plane run with segment_chunk=2 (requests span
    several segment dispatches, so faults can land mid-segment)."""
    backend = (backend if backend is not None
               else ProcBackend(config, device="cpu"))
    sys_ = ServingSystem(n_executors=n_exec, backend=backend, hw=hw,
                         faults=faults)
    sys_.coordinator.scheduler = Scheduler(
        sys_.profiles, use_declared_max_batch=True, segment_chunk=2)
    sys_.register(wf)
    req = sys_.submit(wf.name, inputs=inputs, arrival=0.0, steps=steps)
    return sys_, req


def _image(sys_, req):
    assert req.status == "done", req.status
    return sys_.coordinator.engine.value_of(
        req.ref_key(req.graph.outputs["image"]))


def _proc_segment_exec_indices(backend):
    return [i for i, (model_id, _) in enumerate(backend.exec_log)
            if model_id.startswith("segment:")]


@pytest.fixture(scope="module")
def basic_runs(spawnable):
    """The basic request on the in-process plane and on the proc plane
    (fault-free): the proc system is closed before the tests read it."""
    ref_sys, ref_req = _serve(make_basic_workflow("sd3"),
                              {"seed": 0, "prompt": "a fox"},
                              backend=LocalBackend(device="cpu"))
    ref_sys.run()
    want = _image(ref_sys, ref_req)
    sys_, req = _serve(make_basic_workflow("sd3"),
                       {"seed": 0, "prompt": "a fox"})
    with sys_:
        sys_.run()
    return want, sys_, req


# --------------------------------------------------------------------------
# parity + staging
# --------------------------------------------------------------------------

def test_proc_parity_and_staging_bitexact(basic_runs):
    """The proc plane reproduces the in-process image bit-exactly, every
    value round-trips through serialized puts, and repeat dispatches to
    the same worker reuse the staging store instead of re-shipping."""
    want, sys_, req = basic_runs
    assert req.status == "done"
    got = _image(sys_, req)
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    co = sys_.coordinator
    be = co.backend
    # serialized datastore: outputs provably crossed the boundary
    assert co.engine.serialized and co.engine.n_encodes > 0
    # segment chaining hit the worker-side staging store
    assert be.staging_hits > 0 and be.staging_ships > 0
    assert be.n_exec_replies == be.n_exec_applied and be.n_fenced == 0
    assert be.bytes_tx > 0 and be.bytes_rx > 0
    assert be.worker_seconds > 0 and be.transport_seconds >= 0
    # the workers ran the forwards: the parent's own backend loaded nothing
    assert not be._components and len(be.rpc_log) == be.n_execs
    assert all(len(h.spawn_seconds) == 1 for h in be.workers.values())
    assert_invariants(co)


# --------------------------------------------------------------------------
# SIGKILL mid-segment: supervised respawn + lineage replay, bit-exact
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wf_maker,inputs,hw", [
    (lambda: make_basic_workflow("sd3"),
     {"seed": 0, "prompt": "a fox"}, GPU_H800),
    (lambda: make_lora_workflow("sd3", "style"),
     {"seed": 3, "prompt": "styled"}, FAST_FETCH),
], ids=["basic", "lora"])
def test_proc_kill_midsegment_recovery_bitexact(basic_runs, wf_maker, inputs,
                                                hw):
    """kill -9 the lead worker right after the second segment chunk's
    exec frame hits the wire; the supervisor respawns the process and
    recovery reproduces the fault-free image bit-exactly."""
    if hw is GPU_H800:               # the fault-free basic run is shared
        _, ref_sys, ref_req = basic_runs
        want = _image(ref_sys, ref_req)
        seg_idxs = _proc_segment_exec_indices(ref_sys.coordinator.backend)
    else:
        ref_sys, ref_req = _serve(wf_maker(), inputs, hw=hw)
        with ref_sys:
            ref_sys.run()
            want = _image(ref_sys, ref_req)
            seg_idxs = _proc_segment_exec_indices(ref_sys.coordinator.backend)
    assert len(seg_idxs) >= 2, "need >=2 segment chunks to kill mid-segment"

    faults = FaultPlane(seed=0, kill_every_execs=seg_idxs[1], max_kills=1)
    sys_, req = _serve(wf_maker(), inputs, hw=hw, faults=faults)
    with sys_:
        sys_.run()
        co = sys_.coordinator
        assert req.status == "done"
        assert faults.n_kills == 1
        assert co.n_worker_deaths >= 1
        assert co.backend.supervisor.n_spawns >= 3   # 2 workers + respawn
        assert co.backend.restart_seconds > 0
        torch.testing.assert_close(_image(sys_, req), want, rtol=0, atol=0)
        assert_invariants(co)


# --------------------------------------------------------------------------
# heartbeat blackhole: zombie adopted, stale epoch provably fenced
# --------------------------------------------------------------------------

def test_zombie_blackhole_is_fenced(spawnable):
    """Partition a worker's receive path mid-RPC for longer than the
    liveness lease.  The worker keeps computing (a zombie); the parent
    declares it dead, recovers, and the zombie's late ``exec_done``
    arrives with a stale epoch — fenced, never applied twice."""
    wf = make_basic_workflow("sd3")
    cfg = ProcConfig(hb_interval=0.02, hb_timeout=0.25, spawn_timeout=60.0,
                     exec_wall_timeout=60.0)
    # blackhole the 6th exec (first request warms both workers with 5)
    # for longer than the lease: death by heartbeat, then the hold heals
    # inside the renewed lease and the stale frame surfaces
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
        be = co.backend
        assert req2.status == "done"
        assert co.n_heartbeat_deaths >= 1
        assert be.n_fenced >= 1                       # the stale reply
        assert be.n_exec_replies == be.n_exec_applied + be.n_fenced
        # the zombie was ADOPTED, not respawned: same process, new epoch
        assert any(h.epoch >= 1 for h in be.workers.values())
        assert all(h.proc.is_alive() for h in be.workers.values())
        assert check_invariants(co) == []


# --------------------------------------------------------------------------
# frame chaos: duplicated + reordered control frames absorbed
# --------------------------------------------------------------------------

def test_frame_dup_delay_chaos_parity(basic_runs):
    want = basic_runs[0]
    faults = FaultPlane(seed=5, frame_dup_p=0.4, frame_delay_p=0.4)
    sys_, req = _serve(make_basic_workflow("sd3"),
                       {"seed": 0, "prompt": "a fox"}, faults=faults)
    with sys_:
        sys_.run()
        co = sys_.coordinator
        be = co.backend
        assert req.status == "done"
        assert be.n_dup_frames + be.n_delayed_frames > 0
        # a duplicated exec_done is a second reply for a consumed request
        # id: it must land in n_fenced, never apply twice
        assert be.n_exec_replies == be.n_exec_applied + be.n_fenced
        torch.testing.assert_close(_image(sys_, req), want, rtol=0, atol=0)
        assert_invariants(co)


# --------------------------------------------------------------------------
# supervisor restart lifecycle
# --------------------------------------------------------------------------

def test_supervisor_restart_rotates_pid_and_epoch(spawnable):
    """Kill an idle worker directly: the liveness sweep (not an RPC)
    detects the exit, recovery respawns through the warm-pool path, the
    pid rotates, the epoch bumps, and the next request lands fine."""
    wf = make_basic_workflow("sd3")
    sys_, req1 = _serve(wf, {"seed": 0, "prompt": "a"})
    with sys_:
        sys_.run()
        assert req1.status == "done"
        co = sys_.coordinator
        be = co.backend
        victim = next(iter(be.workers))
        old = be.workers[victim]
        old_pid, old_epoch = old.pid, old.epoch
        be.kill_worker(victim)
        deadline = time.monotonic() + 10.0
        while old.proc.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not old.proc.is_alive()

        req2 = sys_.submit(wf.name, inputs={"seed": 2, "prompt": "c"},
                           arrival=co.now, steps=5)
        sys_.run()
        assert req2.status == "done"
        assert co.n_worker_deaths >= 1
        h = be.workers[victim]
        assert h.pid != old_pid and h.proc.is_alive()
        assert h.epoch == old_epoch + 1
        ex = co.by_id[victim]
        assert ex.worker_pid == h.pid and ex.epoch == h.epoch
        assert ex.n_revives >= 1
        # the dead worker's staging view was invalidated: keys re-shipped
        assert be.staging_ships > 0
        assert_invariants(co)


# --------------------------------------------------------------------------
# multi-LoRA adapter shipping: warm refs, kill -> re-ship only the missing
# --------------------------------------------------------------------------

def _mixed_tenant_system():
    """1-executor proc system serving two LoRA tenants + unpatched traffic
    with the multilora scheduler; AsyncLoRAPass is stripped so adapter
    resolution is deterministic (its fold-in depends on wall seconds)."""
    be = ProcBackend(FAST, device="cpu")
    sys_ = ServingSystem(n_executors=1, backend=be)
    sys_.registry = WorkflowRegistry(GraphCompiler(
        [InlineTrivialPass(), SegmentFusionPass(), JitCompilePass()]))
    sys_.coordinator.scheduler = Scheduler(
        sys_.profiles, use_declared_max_batch=True, multilora=True)
    ms = ModelSet(FAMILIES["sd3"])
    for wf in (make_basic_workflow("sd3", ms),
               make_lora_workflow("sd3", "tenantA", ms),
               make_lora_workflow("sd3", "tenantB", ms)):
        sys_.register(wf)
    return sys_, be


def _mixed_wave(sys_):
    reqs = [sys_.submit(name, inputs={"seed": 3, "prompt": "tenants"},
                        arrival=sys_.coordinator.now, steps=3)
            for name in ("sd3:lora:tenantA", "sd3:lora:tenantB", "sd3:basic")]
    sys_.run()
    assert all(r.status == "done" for r in reqs)
    return reqs


def test_proc_adapter_factors_reship_after_kill(spawnable):
    """Decoded A/B factors ride the staging protocol: shipped once, then
    referenced by key; a killed worker's recovery invalidates its staging
    view, so the next mixed batch re-ships EXACTLY the missing factor
    sets — nothing more — and the grouped route stays correct."""
    sys_, be = _mixed_tenant_system()
    with sys_:
        reqs1 = _mixed_wave(sys_)
        assert any(b.multilora for b in sys_.coordinator.dispatch_log)
        # two tenants -> two factor sets shipped as payload, no refs yet
        assert be.adapter_ships == 2 and be.adapter_hits == 0

        # warm second wave: the worker holds both factor sets staged, so
        # the parent sends bare refs and ships nothing
        _mixed_wave(sys_)
        assert be.adapter_ships == 2 and be.adapter_hits >= 2

        want = [_image(sys_, r) for r in reqs1]

        victim = next(iter(be.workers))
        be.kill_worker(victim)
        reqs3 = _mixed_wave(sys_)
        co = sys_.coordinator
        assert co.n_worker_deaths >= 1
        # recovery re-shipped only the two missing factor sets
        assert be.adapter_ships == 4
        # the re-shipped adapters produce the same images as before
        for img, r_new in zip(want, reqs3):
            torch.testing.assert_close(_image(sys_, r_new), img, rtol=0,
                                       atol=0)
        assert_invariants(co)


# --------------------------------------------------------------------------
# the slice against the JAX package, on given weights
# --------------------------------------------------------------------------

def _jax_images():
    system = jcore.ServingSystem(n_executors=2, backend=jcore.LocalBackend())
    system.register(jdiff.make_basic_workflow("sd3"))
    reqs = [system.submit("sd3:basic", inputs=dict(inp), arrival=0.0,
                          steps=5) for inp in REQUESTS]
    system.run()
    return [np.asarray(system.coordinator.engine.value_of(
        r.ref_key(r.graph.outputs["image"]))) for r in reqs]


def _port_modelset_from_jax():
    """A port ModelSet carrying the JAX package's weights and latents (as
    ``tests/test_torch_serving.py`` builds it)."""
    jms = jdiff.ModelSet(jdiff.FAMILIES["sd3"])
    ms = ModelSet(FAMILIES["sd3"])
    for name in ("text_enc", "backbone", "vae_dec"):
        params = getattr(jms, name).load()["params"]
        getattr(ms, name).weights = from_numpy(jax.tree.map(np.asarray, params))
    cfg = ms.family.toy
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    ms.latents.source = lambda seed: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))
    return ms


def _weight_id(model_id):
    return model_id[len("segment:"):] if model_id.startswith("segment:") \
        else model_id


def _rel(got, want):
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _frame_tensors(obj, out):
    """Every tensor in a decoded frame, Models' attributes included."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _frame_tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _frame_tensors(v, out)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        _frame_tensors(vars(obj), out)
    return out


def test_proc_image_matches_jax_and_weights_cross_once(spawnable,
                                                       monkeypatch):
    want = _jax_images()
    ms = _port_modelset_from_jax()
    sizes = {m.model_id: sum(t.numel() * t.element_size() for t in
                             _frame_tensors(m.weights, []))
             for m in (ms.text_enc, ms.backbone, ms.vae_dec)}
    frames = []
    real_send = FrameChannel.send

    def spy(self, msg):
        if msg.get("kind") == "exec":
            frames.append(encode_frame(msg))
        return real_send(self, msg)

    monkeypatch.setattr(FrameChannel, "send", spy)
    system = ServingSystem(n_executors=2,
                           backend=ProcBackend(FAST, device="cpu"))
    system.register(make_basic_workflow("sd3", ms=ms))
    with system:
        be = system.coordinator.backend
        waves = []
        for wave in range(2):
            if wave == 1:          # every worker killed between the waves
                n_before = len(be.exec_log)
                for eid in be.workers:
                    be.kill_worker(eid)
                deadline = time.monotonic() + 10.0
                while (any(h.proc.is_alive() for h in be.workers.values())
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
            reqs = [system.submit("sd3:basic", inputs=dict(inp),
                                  arrival=system.coordinator.now, steps=5)
                    for inp in REQUESTS]
            system.run()
            waves.append([_image(system, r) for r in reqs])
        assert system.coordinator.n_worker_deaths >= 1
        assert_invariants(system.coordinator)
    for images in waves:
        for got, w in zip(images, want):
            assert tuple(got.shape) == w.shape and got.dtype == torch.float32
            assert _rel(got.numpy(), w) < 1e-4
    # each worker incarnation got each model's weights once: every exec
    # reaches one weighted model, shipped on its worker's first use of it,
    # and the respawned workers got them exactly once more
    before = {(e, _weight_id(m)) for m, e in be.exec_log[:n_before]}
    after = {(e, _weight_id(m)) for m, e in be.exec_log[n_before:]}
    assert {w for _, w in before} == {w for _, w in after} == set(sizes)
    assert be.weight_ships == len(before) + len(after)
    assert be.weight_hits == len(be.exec_log) - be.weight_ships
    # no exec frame carries an op's weights, or a tensor off the CPU; a
    # frame that ships no weights is smaller than the smallest tree
    assert len(frames) == len(be.exec_log)
    for frame in frames:
        msg = decode_value(frame[HEADER_BYTES:])
        assert all(getattr(m, "weights", None) is None
                   for m in sup._models(msg["op"]))
        assert all(t.device.type == "cpu" for t in _frame_tensors(msg, []))
        specs = msg.get("weights") or {}
        assert len(specs) == 1
        if all(s[0] == "ref" for s in specs.values()):
            assert len(frame) < min(sizes.values())


# --------------------------------------------------------------------------
# devices: no card, no fallback; seeded factors land on the pool's device
# --------------------------------------------------------------------------

def test_proc_backend_without_cuda_raises(monkeypatch):
    """``ProcBackend()`` runs its workers on the card: without one it
    raises at construction, before any process is spawned, and so does
    ``ServingSystem(backend="proc")``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend is valid")
    import multiprocessing

    def no_spawn(*a, **k):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(multiprocessing, "get_context", no_spawn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProcBackend(FAST)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProcBackend(FAST, device="cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingSystem(n_executors=1, backend="proc")
    be = ProcBackend(FAST, device="cpu")
    assert be.device == torch.device("cpu") and not be.workers
    be.close()


def test_adapter_pool_seed_puts_factors_on_the_pool_device():
    """A worker decodes adapter factors off the wire as CPU tensors;
    ``seed`` moves them onto the pool's device (``meta`` here stands in
    for the card), keeping dtypes and shapes, quantized dicts included."""
    from repro_torch.core.executor import AdapterPool
    from repro_torch.diffusion.ops import LoRAAdapter

    comps = LoRAAdapter(FAMILIES["sd3"], "seeded").load("cpu")
    pool = AdapterPool(1 << 30, device=torch.device("meta"))
    pool.seed("lora:seeded:sd3", comps)
    got = pool._entries["lora:seeded:sd3"]
    cpu, meta = [], []
    _frame_tensors(comps, cpu)
    _frame_tensors(got, meta)
    assert cpu and len(meta) == len(cpu)
    for a, b in zip(cpu, meta):
        assert b.device.type == "meta"
        assert (b.dtype, b.shape) == (a.dtype, a.shape)
    assert pool.resident_bytes == sum(t.numel() * t.element_size()
                                      for t in cpu)
    # a pool without a device keeps what it is given
    bare = AdapterPool(1 << 30)
    bare.seed("lora:seeded:sd3", comps)
    assert bare._entries["lora:seeded:sd3"] is comps
