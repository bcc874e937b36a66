"""The port's sharded executor plane (``MeshManager``, ``Submesh``,
``ShardedBackend`` and the sharded forwards) on the CPU, against the JAX
package and against the port's own single-device path, at the toy SD3
size (8 patch rows, so k = 2 and 4 divide the grid).  The served
workflows and the JAX package's own sharded functions are in
``tests/test_torch_mesh_served.py``.

Slots are ``torch.device("cpu")`` objects told apart by identity, as the
JAX package's tests tell forced virtual CPU devices apart; the whole
sharded program runs on them: the row scatter, the per-layer K/V
all-gather, the gather back to the home slot and the fallbacks.

Tolerances, and why:

* a sharded function or ``execute_batch_sharded`` against the JAX
  package's single-device function on the same numpy-seeded inputs and
  carried weights: atol = rtol = 1e-4, the JAX package's own
  sharded-vs-single gate (``tests/test_mesh_exec.py``);
* against the port's own single-device function: atol = rtol = 1e-5 (the
  same f32 arithmetic, blocked over fewer rows or tokens);
* a one-slot or disabled ``ShardedBackend``: bit for bit the
  ``LocalBackend``'s outputs (the same path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.diffusion as jdiff
from repro.diffusion import mmdit as jm
from repro.diffusion import sampler as js
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
from repro_torch.core import MeshManager, ShardedBackend, sharded_exec_enabled
from repro_torch.core.profiles import GPU_H800
from repro_torch.diffusion import mmdit as tm
from repro_torch.diffusion import sampler as tsamp
from repro_torch.weights import from_numpy

JCFG = jdiff.FAMILIES["sd3"].toy
TCFG = tdiff.FAMILIES["sd3"].toy


def _slots(n=4):
    return [torch.device("cpu") for _ in range(n)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _live_cond(params, seed=5):
    """The JAX tree with a nonzero ``cond_embed`` (the JAX package draws
    it with scale 0, with which the conditioning could not be tested)."""
    ce = params["cond_embed"]
    w = np.random.default_rng(seed).standard_normal(ce.shape) / np.sqrt(
        ce.shape[0])
    return {**params, "cond_embed": jnp.asarray(w, jnp.float32).astype(ce.dtype)}


# --------------------------------------------------------------------------
# MeshManager and Submesh (pure logic; CPU slots)
# --------------------------------------------------------------------------

def test_mesh_manager_partitions_slots_per_executor():
    d = _slots(4)
    mm = MeshManager(devices=d)
    assert mm.device_of(0) is d[0] and mm.device_of(3) is d[3]
    assert mm.device_of(4) is d[0]          # fleet larger than the slots: wrap
    assert mm.devices_of([0, 1, 4, 5]) == [d[0], d[1]]   # dedup, ordered
    assert mm.devices_of([0, 1, 4, 5])[1] is d[1]
    assert mm.assemblable([0, 1, 2]) == 3
    assert mm.assemblable([0, 4]) == 1      # the same slot twice
    assert mm.max_k() == 4                  # four slots of one device
    sub = mm.submesh([1, 0, 5])
    assert sub.slots == (1, 0) and sub.size == 2 and sub.home is d[1]
    assert mm.submesh([5, 4]) is sub        # cached per slot tuple
    # the same slot object listed twice is one slot
    shared = MeshManager(devices=[d[0], d[0], d[1]])
    assert shared.max_k() == 2 and shared.submesh([1, 2]).slots == (0, 2)


def test_mesh_manager_clamp_and_disable(monkeypatch):
    mm = MeshManager(devices=_slots(2))
    assert mm.clamp(4, [0, 1, 2]) == 2
    assert mm.clamp(1, [0]) == 1
    monkeypatch.setenv("REPRO_SHARDED_EXEC", "0")
    assert not sharded_exec_enabled()
    assert mm.clamp(4, [0, 1]) == 1
    assert mm.max_k() == 1
    with pytest.raises(ValueError):
        MeshManager(devices=[])


def test_default_slots_are_the_cards():
    """With no devices the manager takes every CUDA card, and raises where
    there is none (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        mm = MeshManager()
        assert [d.type for d in mm.devices] == ["cuda"] * torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshManager()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedBackend()


def test_submesh_collectives():
    sub = MeshManager(devices=_slots(4)).submesh([0, 1, 2, 3])
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    parts = sub.scatter(x, dim=1)
    assert [tuple(p.shape) for p in parts] == [(2, 2, 3)] * 4
    # a slot on the tensor's own device takes a view: no copy
    assert parts[1].data_ptr() == x[:, 2:4].data_ptr()
    gathered = sub.all_gather(parts, dim=1)
    assert len(gathered) == 4 and all(torch.equal(g, x) for g in gathered)
    assert gathered[0].data_ptr() != x.data_ptr()        # cat copies
    assert torch.equal(sub.gather(parts, dim=1), x)
    with pytest.raises(ValueError):
        sub.scatter(x, dim=2)
    # a replica on the tree's own device aliases its tensors, and its
    # device leaves name the slot
    tree = {"w": x, "device": torch.device("cpu"), "cfg": "c", "l": [x]}
    reps = sub.replicate(tree)
    assert len(reps) == 4
    assert all(r["w"] is x and r["l"][0] is x and r["cfg"] == "c" for r in reps)
    assert all(r["device"] == torch.device("cpu") for r in reps)


# the JAX package's scheduler mesh tests (tests/test_scheduler.py), on the
# port's Scheduler with CPU slots

class _CostOnly(tcore.Model):
    def __init__(self, model_id, **cost_kw):
        self._cost_kw = cost_kw
        super().__init__(model_id=model_id)

    def setup_io(self):
        self.add_input("x", tcore.TensorType())
        self.add_output("y", tcore.TensorType())

    def cost(self):
        kw = dict(flops_per_item=5e13, param_bytes=4e9, act_io_bytes=1e9,
                  output_bytes=4e6)
        kw.update(self._cost_kw)
        return tcore.ModelCost(**kw)


def _profiles(**cost_kw):
    ps = tcore.ProfileStore(GPU_H800)
    ps.profile_model(_CostOnly("m", **cost_kw))
    return ps


def test_mesh_clamps_k_to_assemblable_submesh():
    ps = _profiles(max_parallelism=8)
    mesh = MeshManager(devices=_slots(2))
    s = tcore.Scheduler(ps, mesh=mesh)
    assert s.choose_parallelism("m", 4, avail_ids=[0, 1, 2, 3]) == 2
    assert s.choose_parallelism("m", 2, avail_ids=[0, 2]) == 1
    sf = tcore.Scheduler(ps, fixed_parallelism=8, mesh=mesh)
    assert sf.choose_parallelism("m", 8, avail_ids=[0, 1, 2, 3]) == 2


def test_mesh_disabled_forces_single_device(monkeypatch):
    monkeypatch.setenv("REPRO_SHARDED_EXEC", "0")
    mesh = MeshManager(devices=_slots(4))
    s = tcore.Scheduler(_profiles(max_parallelism=8), mesh=mesh)
    assert s.choose_parallelism("m", 4, avail_ids=[0, 1, 2, 3]) == 1


def test_fixed_parallelism_waits_when_free_executors_share_slots():
    ps = _profiles(max_parallelism=4)
    mesh = MeshManager(devices=_slots(2))
    sched = tcore.Scheduler(ps, fixed_parallelism=2, mesh=mesh,
                            use_declared_max_batch=True)

    class _Node:
        model_id = "m"
        arrival_time, depth, seq = 0.0, 0, 0
        effective_patches = ()
        batch_key = ("m", ())

    fetch = lambda batch, eid: 0.0
    ready = [_Node()]
    decisions = sched.schedule_cycle(
        ready, [tcore.Executor(0, ps), tcore.Executor(2, ps)], fetch)
    assert decisions == [] and len(ready) == 1
    decisions = sched.schedule_cycle(
        ready, [tcore.Executor(0, ps), tcore.Executor(1, ps)], fetch)
    assert len(decisions) == 1 and decisions[0].parallelism == 2
    assert sorted(decisions[0].executor_ids) == [0, 1]


# --------------------------------------------------------------------------
# Shared toy weights and inputs (the JAX package's draws, carried across)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The JAX package's toy components (ControlNet ``cond_embed`` made
    nonzero) and a port ModelSet carrying the same weights."""
    jms = jdiff.ModelSet(jdiff.FAMILIES["sd3"])
    jc = {name: getattr(jms, name).load()
          for name in ("backbone", "cn1", "vae_dec")}
    jc["cn1"] = {**jc["cn1"], "params": _live_cond(jc["cn1"]["params"])}
    ms = tdiff.ModelSet(tdiff.FAMILIES["sd3"])
    ms.backbone.weights = from_numpy(_numpy_tree(jc["backbone"]["params"]))
    ms.cn1.weights = from_numpy(_numpy_tree(jc["cn1"]["params"]))
    ms.vae_dec.weights = ms.vae_enc.weights = from_numpy(
        _numpy_tree(jc["vae_dec"]["params"]))
    return jms, jc, ms


def _kws(kind, n, seed):
    """``n`` requests' inputs for ``kind`` as (JAX kwargs, port kwargs)."""
    r = np.random.default_rng(seed)
    lat_shape = (1, JCFG.latent_size, JCFG.latent_size, JCFG.latent_channels)
    out = []
    for i in range(n):
        if kind == "image":
            kw = {"image": r.uniform(-1, 1, (1, 8 * JCFG.latent_size,
                                             8 * JCFG.latent_size, 3))}
        else:
            kw = {"latents": r.standard_normal(lat_shape)}
        if kind in ("backbone", "cn"):
            kw["prompt_embeds"] = r.standard_normal(
                (1, JCFG.text_tokens, JCFG.text_dim))
            kw["t"] = 0.25 + 0.1 * i
        if kind == "backbone":
            kw["guidance"] = 3.0 + i         # heterogeneous per-item guidance
        if kind == "cn":
            kw["cond_latents"] = r.standard_normal(lat_shape)
        out.append(kw)
    cast = lambda v: v.astype(np.float32) if isinstance(v, np.ndarray) else v
    jkws = [{k: (jnp.asarray(cast(v)) if isinstance(v, np.ndarray) else v)
             for k, v in kw.items()} for kw in out]
    tkws = [{k: (torch.from_numpy(cast(v)) if isinstance(v, np.ndarray) else v)
             for k, v in kw.items()} for kw in out]
    return jkws, tkws


def _sharded(k, n_slots=4):
    mm = MeshManager(devices=_slots(n_slots))
    return ShardedBackend(mm), mm.submesh(list(range(k)))


# --------------------------------------------------------------------------
# ShardedBackend degrades to LocalBackend
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["one-slot", "disabled"])
def test_sharded_backend_degrades_to_local(models, monkeypatch, case):
    """One slot, or ``REPRO_SHARDED_EXEC=0``: the backend is a plain
    ``LocalBackend`` (no shard log, the same outputs bit for bit)."""
    _, _, ms = models
    if case == "disabled":
        monkeypatch.setenv("REPRO_SHARDED_EXEC", "0")
        backend, mesh = _sharded(2)
    else:
        backend, mesh = _sharded(1, n_slots=1)
    assert not backend.enabled
    _, kws = _kws("backbone", 1, 0)
    outs, _, _ = backend.execute_batch(ms.backbone, [dict(kw) for kw in kws],
                                       mesh=mesh)
    ref, _, _ = tcore.LocalBackend(device="cpu").execute_batch(
        ms.backbone, [dict(kw) for kw in kws])
    assert torch.equal(outs[0]["velocity"], ref[0]["velocity"])
    assert backend.shard_log == []


def test_replicas_alias_and_key_by_slot(models):
    """Four slots of one device hold one copy of the weights; the cache
    keys on slots, so each submesh is its own placement; unload drops
    them."""
    _, _, ms = models
    backend, mesh = _sharded(4)
    reps, _ = backend.replicated_components(ms.backbone, [], mesh)
    home, _ = backend.ensure_loaded(ms.backbone)
    w = home["params"]["layers"]["img"]["wq"]
    assert len(reps) == 4
    assert all(r["params"]["layers"]["img"]["wq"] is w for r in reps)
    again, _ = backend.replicated_components(ms.backbone, [], mesh)
    assert again is reps
    pair = backend.mesh_manager.submesh([2, 3])
    other, _ = backend.replicated_components(ms.backbone, [], pair)
    assert other is not reps and len(backend._replicated) == 2
    backend.unload(ms.backbone.model_id)
    assert backend._replicated == {}


# --------------------------------------------------------------------------
# Module parity: the sharded forwards
# --------------------------------------------------------------------------

def _mmdit_inputs(b=2, seed=1):
    r = np.random.default_rng(seed)
    lat = r.standard_normal((b, JCFG.latent_size, JCFG.latent_size,
                             JCFG.latent_channels)).astype(np.float32)
    t = np.linspace(0.9, 0.3, b).astype(np.float32)
    emb = r.standard_normal((b, JCFG.text_tokens, JCFG.text_dim)).astype(np.float32)
    null = r.standard_normal(emb.shape).astype(np.float32)
    res = (0.1 * r.standard_normal((JCFG.n_layers, b, JCFG.image_tokens,
                                    JCFG.d_model))).astype(np.float32)
    return lat, t, emb, null, res


@pytest.mark.parametrize("with_res", [False, True], ids=["no-res", "res"])
@pytest.mark.parametrize("k", [2, 4])
def test_mmdit_apply_seq_sharded_matches_single(models, k, with_res):
    jms, jc, _ = models
    jp = jc["backbone"]["params"]
    tp = from_numpy(_numpy_tree(jp))
    lat, t, emb, _, res = _mmdit_inputs()
    res = res if with_res else None
    want = jm.mmdit_apply(jp, JCFG, *map(jnp.asarray, (lat, t, emb)),
                          None if res is None else jnp.asarray(res))
    targs = [torch.from_numpy(a) for a in (lat, t, emb)]
    tres = None if res is None else torch.from_numpy(res)
    single = tm.mmdit_apply(tp, TCFG, *targs, tres)
    _, mesh = _sharded(k)
    got = tm.mmdit_apply_seq_sharded(tp, TCFG, *targs, tres, mesh)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-4)
    _close(got, single, 1e-5)


def test_latent_parallel_velocity_matches_cfg_velocity(models):
    """Latent parallelism over 2 slots against the sequential two-pass CFG
    of both packages; the port's sequential CFG against the JAX package's."""
    _, jc, _ = models
    jp = jc["backbone"]["params"]
    tp = from_numpy(_numpy_tree(jp))
    lat, t, emb, null, _ = _mmdit_inputs()
    want = js.cfg_velocity(jp, JCFG, *map(jnp.asarray, (lat, t, emb, null)), 4.0)
    targs = [torch.from_numpy(a) for a in (lat, t, emb, null)]
    seq = tsamp.cfg_velocity(tp, TCFG, *targs, 4.0)
    _close(seq, want, 1e-4)
    _, mesh = _sharded(2)
    got = tsamp.latent_parallel_velocity(mesh, tp, TCFG, *targs, 4.0)
    _close(got, want, 1e-4)
    _close(got, seq, 1e-5)
    with pytest.raises(ValueError):
        tsamp.latent_parallel_velocity(_sharded(4)[1], tp, TCFG, *targs)


@pytest.mark.parametrize("k,n_req", [(2, 1), (2, 3), (4, 2), (4, 1)],
                         ids=["k2-cfg-branches", "k2-rows", "k4-rows",
                              "k4-sequence"])
def test_backbone_sharded_parity(models, k, n_req):
    """k = 2 with one request splits the CFG branches; 3 requests at k = 2
    and 2 at k = 4 split rows; one request at k = 4 shards the tokens."""
    jms, jc, ms = models
    jkws, tkws = _kws("backbone", n_req, 7)
    want = jms.backbone.execute_batch(jc["backbone"], jkws)
    ref, _, _ = tcore.LocalBackend(device="cpu").execute_batch(
        ms.backbone, [dict(kw) for kw in tkws])
    backend, mesh = _sharded(k)
    out, _, _ = backend.execute_batch(ms.backbone, [dict(kw) for kw in tkws],
                                      mesh=mesh)
    for o, r, w in zip(out, ref, want):
        assert o["velocity"].device.type == "cpu"
        _close(o["velocity"], w["velocity"], 1e-4)
        _close(o["velocity"], r["velocity"], 1e-5)
    assert backend.shard_log == [(ms.backbone.model_id, n_req, k,
                                  tuple(range(k)))]


def test_controlnet_and_vae_sharded_parity(models):
    """The ControlNet branch over 2 slots (residuals gathered on their
    batch axis), the VAE decoder over 4 and the encoder over 2."""
    jms, jc, ms = models
    cases = [(ms.cn1, jms.cn1, jc["cn1"], "cn", 2, 2, "controlnet_residuals"),
             (ms.vae_dec, jms.vae_dec, jc["vae_dec"], "latents", 4, 4, "image"),
             (ms.vae_enc, jms.vae_enc, jc["vae_dec"], "image", 2, 2,
              "cond_latents")]
    for tmodel, jmodel, jcomps, kind, n, k, key in cases:
        jkws, tkws = _kws(kind, n, 3)
        want = jmodel.execute_batch(jcomps, jkws)
        ref, _, _ = tcore.LocalBackend(device="cpu").execute_batch(
            tmodel, [dict(kw) for kw in tkws])
        backend, mesh = _sharded(k)
        out, _, _ = backend.execute_batch(tmodel, [dict(kw) for kw in tkws],
                                          mesh=mesh)
        for o, r, w in zip(out, ref, want):
            assert tuple(o[key].shape) == tuple(np.shape(w[key]))
            _close(o[key], w[key], 1e-4)
            _close(o[key], r[key], 1e-5)
        assert backend.shard_log == [(tmodel.model_id, n, k, tuple(range(k)))]


def test_indivisible_batch_falls_back_to_single_device(models):
    """One CFG pair on 3 slots: 2 rows and 8 patch rows divide by neither
    mode, so the backbone declines and the backend runs its single-device
    forward (no shard log)."""
    _, _, ms = models
    _, tkws = _kws("backbone", 1, 7)
    backend, mesh = _sharded(3)
    out, _, _ = backend.execute_batch(ms.backbone, [dict(kw) for kw in tkws],
                                      mesh=mesh)
    assert backend.shard_log == []
    ref, _, _ = tcore.LocalBackend(device="cpu").execute_batch(
        ms.backbone, [dict(kw) for kw in tkws])
    assert torch.equal(out[0]["velocity"], ref[0]["velocity"])


@pytest.mark.parametrize("n_cns", [0, 1])
@pytest.mark.parametrize("k", [2, 4])
def test_segment_sharded_parity(models, k, n_cns):
    """The fused segment over k slots (k = 2: the CFG branches on two
    slots every step; k = 4: the tokens, the ControlNet once on the home
    slot) against the JAX package's single-device segment and the port's."""
    jms, jc, ms = models
    jseg = jms.backbone.build_segment([jms.cn1][:n_cns], 3)
    jcomps = jseg.load()
    if n_cns:
        jcomps["cns"][0] = {**jcomps["cns"][0], "params": jc["cn1"]["params"]}
    tseg = ms.backbone.build_segment([ms.cn1][:n_cns], 3)
    r = np.random.default_rng(1)
    shape = (1, JCFG.latent_size, JCFG.latent_size, JCFG.latent_channels)
    arrs = {"latents": r.standard_normal(shape),
            "prompt_embeds": r.standard_normal((1, JCFG.text_tokens,
                                                JCFG.text_dim))}
    if n_cns:
        arrs["cond_latents"] = r.standard_normal(shape)
    sched = [1.0, 2 / 3, 1 / 3, 0.0]
    lit = {"t_mid": tuple(sched[:3]), "t_cur": tuple(sched[:3]),
           "t_next": tuple(sched[1:]), "guidance": 4.0}
    jkw = {**{n: jnp.asarray(a.astype(np.float32)) for n, a in arrs.items()},
           **lit}
    tkw = {**{n: torch.from_numpy(a.astype(np.float32)) for n, a in arrs.items()},
           **lit}
    want = jseg.execute_batch(jcomps, [dict(jkw)])[0]["latents"]
    ref, _, _ = tcore.LocalBackend(device="cpu").execute_batch(tseg, [dict(tkw)])
    backend, mesh = _sharded(k)
    out, _, _ = backend.execute_batch(tseg, [dict(tkw)], mesh=mesh)
    _close(out[0]["latents"], want, 1e-4)
    _close(out[0]["latents"], ref[0]["latents"], 1e-5)
    assert backend.shard_log == [(tseg.model_id, 1, k, tuple(range(k)))]
    # the caller's latents are not the carry: nothing wrote them
    assert torch.equal(tkw["latents"], torch.from_numpy(
        arrs["latents"].astype(np.float32)))


@pytest.mark.parametrize("k", [2, 4])
def test_segment_sharded_donated_carry(models, k):
    """Under ``REPRO_DONATE`` the sharded segment updates only its own
    carry (``_stack``'s copy on the home slot): the caller's latents stay
    as they were, and the result equals the out-of-place run bit for
    bit."""
    _, _, ms = models
    seg = ms.backbone.build_segment([ms.cn1], 3)
    r = np.random.default_rng(4)
    shape = (1, TCFG.latent_size, TCFG.latent_size, TCFG.latent_channels)
    kw = {"latents": torch.from_numpy(r.standard_normal(shape).astype(np.float32)),
          "cond_latents": torch.from_numpy(
              r.standard_normal(shape).astype(np.float32)),
          "prompt_embeds": torch.from_numpy(r.standard_normal(
              (1, TCFG.text_tokens, TCFG.text_dim)).astype(np.float32)),
          "t_mid": (1.0, 0.6, 0.3), "t_cur": (1.0, 0.6, 0.3),
          "t_next": (0.6, 0.3, 0.0), "guidance": 4.0}
    before = kw["latents"].clone()
    outs = {}
    for donate in (False, True):
        prev = tsamp.set_donate_buffers(donate)
        try:
            backend, mesh = _sharded(k)
            out, _, _ = backend.execute_batch(seg, [dict(kw)], mesh=mesh)
        finally:
            tsamp.set_donate_buffers(prev)
        assert backend.ensure_loaded(seg)[0]["donate"] is donate
        assert backend.shard_log and backend.shard_log[-1][2] == k
        outs[donate] = out[0]["latents"]
    assert torch.equal(kw["latents"], before)
    assert torch.equal(outs[True], outs[False])
