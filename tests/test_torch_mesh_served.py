"""The port's sharded executor plane end to end on the CPU: served
workflows on ``ShardedBackend`` over 4 ``torch.device("cpu")`` slots, and
the JAX package's own sharded functions on 4 forced virtual CPU devices
(in a subprocess), against the port's, at the toy SD3 size (8 patch
rows, so k = 2 and 4 divide the grid).  The logic and the module parity
are in ``tests/test_torch_mesh.py``.

Tolerances, and why:

* the port's ``mmdit_apply_seq_sharded`` (k = 4) and
  ``latent_parallel_velocity`` (k = 2) against the JAX package's: atol =
  rtol = 1e-4, the JAX package's sharded-vs-single gate
  (``tests/test_mesh_exec.py``);
* served images: within 1e-4 max-abs of the port's single-device image
  (the JAX package's served sharded gate) and 1e-4 relative of the JAX
  package's image (``tests/test_torch_serving.py``'s bound); after a
  crash mid-segment at k = 2, atol 1e-5 (the JAX package's chaos test);
* under ``REPRO_SHARDED_EXEC=0``: bit for bit the ``LocalBackend``'s image
  (the same path).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as jcore
import repro.diffusion as jdiff
import repro.diffusion.ops as jops
from repro.diffusion import mmdit as jm
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
from repro_torch.core import MeshManager, ShardedBackend
from repro_torch.diffusion import mmdit as tm
from repro_torch.diffusion import sampler as tsamp
from repro_torch.sim import check_invariants
from repro_torch.weights import from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jdiff.FAMILIES["sd3"].toy
TCFG = tdiff.FAMILIES["sd3"].toy


def _sharded(k, n_slots=4):
    mm = MeshManager(devices=[torch.device("cpu") for _ in range(n_slots)])
    return ShardedBackend(mm), mm.submesh(list(range(k)))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _live_cond(params, seed=5):
    """The JAX tree with a nonzero ``cond_embed`` (the JAX package draws
    it with scale 0, with which the conditioning could not be tested)."""
    ce = params["cond_embed"]
    w = np.random.default_rng(seed).standard_normal(ce.shape) / np.sqrt(
        ce.shape[0])
    return {**params, "cond_embed": jnp.asarray(w, jnp.float32).astype(ce.dtype)}


def test_sharded_exec_flag_disables_sharding(monkeypatch):
    """The served workflow under ``REPRO_SHARDED_EXEC=0``: no sharded
    forward, every dispatch at k = 1, the single-device image bit for
    bit."""
    ms = tdiff.ModelSet(tdiff.FAMILIES["sd3"])
    monkeypatch.setenv("REPRO_SHARDED_EXEC", "0")
    backend, _ = _sharded(4)
    img, system = _serve(ms, backend, 4, n_req=1)
    assert backend.shard_log == []
    assert all(d.parallelism == 1 for d in system.coordinator.dispatch_log)
    monkeypatch.delenv("REPRO_SHARDED_EXEC")
    want, _ = _serve(ms, tcore.LocalBackend(device="cpu"), 1, n_req=1)
    assert torch.equal(img[0], want[0])



# --------------------------------------------------------------------------
# The JAX package's own sharded functions (forced virtual devices)
# --------------------------------------------------------------------------

_JAX_SHARDED = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.core import MeshManager
from repro.diffusion import FAMILIES
from repro.diffusion.mmdit import init_mmdit, mmdit_apply_seq_sharded
from repro.diffusion.sampler import latent_parallel_velocity

d = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
cfg = FAMILIES["sd3"].toy
params = init_mmdit(jax.random.PRNGKey(0), cfg)
assert jax.device_count() == 4
seq = mmdit_apply_seq_sharded(params, cfg, d["lat"], d["t"], d["emb"],
                              d["res"], MeshManager().submesh([0, 1, 2, 3]))
cfg_mesh = Mesh(np.array(jax.devices()[:2]), ("cfg",))
lpv = latent_parallel_velocity(cfg_mesh, params, cfg, d["lat"], d["t"],
                               d["emb"], d["null"], 4.0)
np.savez(sys.argv[2], seq=np.asarray(seq), lpv=np.asarray(lpv))
"""


def test_jax_sharded_functions_match_port(tmp_path):
    """``mmdit_apply_seq_sharded`` at k = 4 and ``latent_parallel_velocity``
    at k = 2 of the JAX package, on 4 forced virtual CPU devices in a
    subprocess, against the port's on 4 CPU slots."""
    r = np.random.default_rng(3)
    lat = r.standard_normal((2, JCFG.latent_size, JCFG.latent_size,
                             JCFG.latent_channels)).astype(np.float32)
    t = np.asarray([0.9, 0.3], np.float32)
    emb, null = (r.standard_normal((2, JCFG.text_tokens, JCFG.text_dim))
                 .astype(np.float32) for _ in range(2))
    res = (0.1 * r.standard_normal((JCFG.n_layers, 2, JCFG.image_tokens,
                                    JCFG.d_model))).astype(np.float32)
    np.savez(tmp_path / "in.npz", lat=lat, t=t, emb=emb, null=null, res=res)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SHARDED, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    tp = from_numpy(_numpy_tree(jm.init_mmdit(jax.random.PRNGKey(0), JCFG)))
    targs = [torch.from_numpy(a) for a in (lat, t, emb)]
    mm = MeshManager(devices=[torch.device("cpu") for _ in range(4)])
    seq = tm.mmdit_apply_seq_sharded(tp, TCFG, *targs, torch.from_numpy(res),
                                     mm.submesh([0, 1, 2, 3]))
    _close(seq, want["seq"], 1e-4)
    lpv = tsamp.latent_parallel_velocity(mm.submesh([0, 1]), tp, TCFG, *targs,
                                         torch.from_numpy(null), 4.0)
    _close(lpv, want["lpv"], 1e-4)


# --------------------------------------------------------------------------
# End to end: served workflows on the sharded plane
# --------------------------------------------------------------------------

def _port_modelset(jms):
    """A port ModelSet carrying the JAX package's weights and latents."""
    ms = tdiff.ModelSet(tdiff.FAMILIES["sd3"])
    for name in ("text_enc", "backbone", "vae_dec", "vae_enc", "cn1"):
        params = getattr(jms, name).load()["params"]
        getattr(ms, name).weights = from_numpy(_numpy_tree(params))
    shape = (1, TCFG.latent_size, TCFG.latent_size, TCFG.latent_channels)
    ms.latents.source = lambda seed: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))
    return ms


def _serve(ms, backend, n_exec, fixed_k=None, n_req=2, cn=False, steps=2,
           faults=None, segment_chunk=None):
    system = tcore.ServingSystem(n_executors=n_exec, backend=backend,
                                 faults=faults)
    if fixed_k or segment_chunk:
        system.coordinator.scheduler = tcore.Scheduler(
            system.profiles, fixed_parallelism=fixed_k,
            use_declared_max_batch=True, segment_chunk=segment_chunk,
            mesh=getattr(backend, "mesh_manager", None))
    wf = (tdiff.make_controlnet_workflow("sd3", 1, ms) if cn
          else tdiff.make_basic_workflow("sd3", ms))
    system.register(wf)
    reqs = [system.submit(wf.name, inputs=_inputs(i, cn), arrival=0.0,
                          steps=steps) for i in range(n_req)]
    system.run()
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return [system.coordinator.engine.value_of(
        r.ref_key(r.graph.outputs["image"])) for r in reqs], system


def _inputs(i, cn):
    inp = {"seed": i, "prompt": f"p {i}"}
    if cn:
        inp["ref_image"] = np.random.default_rng(i).uniform(
            -1, 1, (1, 8 * TCFG.latent_size, 8 * TCFG.latent_size, 3)
        ).astype(np.float32)
    return inp


def _serve_jax(jms, cn, n_req=2, steps=2):
    system = jcore.ServingSystem(n_executors=1, backend=jcore.LocalBackend())
    wf = (jdiff.make_controlnet_workflow("sd3", 1, jms) if cn
          else jdiff.make_basic_workflow("sd3", jms))
    system.register(wf)
    reqs = [system.submit(wf.name, inputs=_inputs(i, cn), arrival=0.0,
                          steps=steps) for i in range(n_req)]
    system.run()
    assert all(r.status == "done" for r in reqs)
    return [np.asarray(system.coordinator.engine.value_of(
        r.ref_key(r.graph.outputs["image"]))) for r in reqs]


def test_served_basic_k4_shards_the_segment():
    """A fixed k = 4 batch runs on a 4-slot submesh (the scheduler's
    executor set, the manager's slots and the backend's shard log agree)
    and its images match the single-device plane and the JAX package."""
    jms = jdiff.ModelSet(jdiff.FAMILIES["sd3"])
    want = _serve_jax(jms, cn=False)
    ms = _port_modelset(jms)
    single, _ = _serve(ms, tcore.LocalBackend(device="cpu"), 1)
    backend, _ = _sharded(4)
    got, system = _serve(ms, backend, 4, fixed_k=4)
    for g, s, w in zip(got, single, want):
        assert float((g - s).abs().max()) < 1e-4
        assert rel_err(g.numpy(), w) < 1e-4
    segs = [d for d in system.coordinator.dispatch_log
            if d.model_id == "segment:backbone:sd3"]
    assert segs and all(d.parallelism == 4 for d in segs)
    mm = backend.mesh_manager
    for d in segs:
        assert len({id(mm.device_of(e)) for e in d.executor_ids}) == 4
    assert any(s[0] == "segment:backbone:sd3" and s[2] == 4
               and len(set(s[3])) == 4 for s in backend.shard_log)
    assert check_invariants(system.coordinator) == []


def test_served_controlnet_shards_at_an_idle_k(monkeypatch):
    """The ControlNet workflow on an idle 4-executor fleet (adaptive
    parallelism): the fused segment shards, and the images match the
    single-device plane and the JAX package (``cond_embed`` nonzero in
    both)."""
    real = jops.init_controlnet
    monkeypatch.setattr(jops, "init_controlnet",
                        lambda key, cfg, *a: _live_cond(real(key, cfg, *a)))
    jms = jdiff.ModelSet(jdiff.FAMILIES["sd3"])
    want = _serve_jax(jms, cn=True)
    ms = _port_modelset(jms)
    single, _ = _serve(ms, tcore.LocalBackend(device="cpu"), 1, cn=True)
    backend, _ = _sharded(4)
    got, system = _serve(ms, backend, 4, cn=True)
    for g, s, w in zip(got, single, want):
        assert float((g - s).abs().max()) < 1e-4
        assert rel_err(g.numpy(), w) < 1e-4
    models = {s[0] for s in backend.shard_log}
    assert "segment:backbone:sd3+controlnet1:sd3" in models, models
    assert check_invariants(system.coordinator) == []


def test_sharded_mid_segment_crash_recovery():
    """A k = 2 sharded segment whose lead executor crashes mid-chunk: the
    request is requeued, may land on another slot pair, and ends within
    the sharded plane's tolerance of the clean run, invariants clean."""
    ms = tdiff.ModelSet(tdiff.FAMILIES["sd3"])

    def run(faults):
        backend, _ = _sharded(4)
        imgs, system = _serve(ms, backend, 4, fixed_k=2, n_req=1, steps=5,
                              faults=faults, segment_chunk=2)
        assert check_invariants(system.coordinator) == []
        assert any(s[2] == 2 for s in backend.shard_log)
        return system, imgs[0]

    ref_sys, want = run(None)
    idxs = [i for i, d in enumerate(ref_sys.coordinator.dispatch_log)
            if d.model_id.startswith("segment:")]
    assert len(idxs) >= 2, idxs
    faults = tcore.FaultPlane(seed=0, crash_every_batches=idxs[1],
                              max_crashes=1)
    system, got = run(faults)
    assert faults.n_crashes == 1
    assert system.coordinator.n_requeues >= 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
