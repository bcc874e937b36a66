"""Multi-tenant LoRA serving in the port: the grouped forwards against the
JAX package on converted weights, and the system gate of
``tests/test_multilora.py`` restated for ``LocalBackend(device="cpu")``.

Tolerances:

* ``mmdit_apply`` / ``text_encoder_apply`` with adapter stacks: 1e-5
  relative (L2 norm of the difference over the norm of the JAX output), as
  in ``tests/test_torch_mmdit.py``: both compute in f32;
* a served mixed batch against the JAX package's mixed batch: 1e-4
  relative, as in ``tests/test_torch_serving.py`` (three denoising steps of
  f32 forwards whose sums run in another order in each framework);
* grouped images against each tenant's folded solo run: 2e-4 max-abs
  (``PARITY_TOL`` of the JAX test); the unpatched request rides the mixed
  batch bit for bit; fused segments equal the per-step chain bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.diffusion as jdiff
from repro.core.passes import InlineTrivialPass as JInline
from repro.core.passes import JitCompilePass as JJit
from repro.core.passes import SegmentFusionPass as JFusion
from repro.core.registry import WorkflowRegistry as JRegistry
from repro.diffusion import config as jcfg
from repro.diffusion import encoders as je
from repro.diffusion import lora as jl
from repro.diffusion import mmdit as jm
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
from repro_torch.core.passes import (
    InlineTrivialPass,
    JitCompilePass,
    SegmentFusionPass,
)
from repro_torch.core.registry import WorkflowRegistry
from repro_torch.diffusion import config as tcfg
from repro_torch.diffusion import encoders as te
from repro_torch.diffusion import mmdit as tm
from repro_torch.diffusion.ops import DiffusionBackbone, LoRAAdapter, TextEncoder
from repro_torch.weights import from_numpy

SUBS = [("sd3:lora:tenantA", 3), ("sd3:lora:tenantB", 3), ("sd3:basic", 3)]
PARITY_TOL = 2e-4
WIDE = dict(d_model=128, n_layers=2, n_heads=2, d_ff=256, text_dim=96,
            latent_size=8, latent_channels=16, patch=2, text_tokens=5)
CONFIGS = {
    "toy": (jcfg._TOY, tcfg._TOY),
    "wide-bf16": (jcfg.DiTConfig(**WIDE, dtype=jnp.bfloat16),
                  tcfg.DiTConfig(**WIDE, dtype=torch.bfloat16)),
}


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# grouped forwards against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_mmdit_apply_with_lora_stack_matches_jax(name):
    jc, tc = CONFIGS[name]
    jparams = jm.init_mmdit(jax.random.PRNGKey(5), jc)
    jloras = [jl.randomize_lora(jax.random.PRNGKey(i),
                                jl.init_lora(jax.random.PRNGKey(i), jc,
                                             rank=rk, scale=0.5 + i))
              for i, rk in enumerate((8, 4))]
    jstack = jl.stack_loras(jloras)
    r = np.random.default_rng(3)
    lat = r.standard_normal((3, jc.latent_size, jc.latent_size,
                             jc.latent_channels)).astype(np.float32)
    t = np.asarray([0.9, 0.5, 0.25], np.float32)
    emb = r.standard_normal((3, jc.text_tokens, jc.text_dim)).astype(np.float32)
    idx = np.asarray([0, 1, -1], np.int32)
    want = jm.mmdit_apply(jparams, jc, *map(jnp.asarray, (lat, t, emb)),
                          lora_stack=jstack, lora_idx=jnp.asarray(idx))
    tparams = from_numpy(_numpy_tree(jparams))
    got = tm.mmdit_apply(tparams, tc, *map(torch.from_numpy, (lat, t, emb)),
                         lora_stack=from_numpy(_numpy_tree(jstack)),
                         lora_idx=torch.from_numpy(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < 1e-5
    # the unpatched row is the plain forward's row
    plain = tm.mmdit_apply(tparams, tc, *map(torch.from_numpy, (lat, t, emb)))
    assert rel_err(got[2].numpy(), plain[2].numpy()) < 1e-6
    assert rel_err(got[0].numpy(), plain[0].numpy()) > 1e-6


def test_text_encoder_apply_with_lora_stack_matches_jax():
    jp = je.init_text_encoder(jax.random.PRNGKey(0), 512, 64, n_layers=2,
                              n_heads=4, max_len=8)
    jtl = [jl.init_text_lora(jax.random.PRNGKey(10 + i), 64, rank=rk,
                             scale=1.5 - 0.5 * i, amplitude=0.2)
           for i, rk in enumerate((8, 3))]
    jstack = jl.stack_text_loras(jtl)
    prompts = ["a watercolor fox", "two foxes in the snow at dusk", "a fox"]
    idx = np.asarray([1, -1, 0], np.int32)
    want = je.text_encoder_apply(jp, je.tokenize_batch(prompts, 512, 8),
                                 n_heads=4, lora_stack=jstack,
                                 lora_idx=jnp.asarray(idx))
    got = te.text_encoder_apply(from_numpy(_numpy_tree(jp)),
                                te.tokenize_batch(prompts, 512, 8), n_heads=4,
                                lora_stack=from_numpy(_numpy_tree(jstack)),
                                lora_idx=torch.from_numpy(idx))
    assert tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < 1e-5


# --------------------------------------------------------------------------
# the system gate: grouped multi-LoRA == folded solo, per request
# --------------------------------------------------------------------------

def _build_port(ms, multilora, fused=True, backend=None, n_executors=1):
    """Deterministic patch semantics, as the JAX test's ``_build_system``:
    AsyncLoRAPass is left out, so adapters resolve at dispatch in both the
    solo and the mixed runs (its fold-in step depends on measured wall
    seconds).  Returns the system, its backend (``backend``, by default
    ``LocalBackend(device="cpu")``, with ``n_executors``) and the adapter
    models by id."""
    be = backend if backend is not None else tcore.LocalBackend(device="cpu")
    s = tcore.ServingSystem(n_executors=n_executors, backend=be)
    passes = ([InlineTrivialPass()] + ([SegmentFusionPass()] if fused else [])
              + [JitCompilePass()])
    s.registry = WorkflowRegistry(tcore.GraphCompiler(passes))
    s.coordinator.scheduler = tcore.Scheduler(
        s.profiles, use_declared_max_batch=True, multilora=multilora)
    wfs = (tdiff.make_basic_workflow("sd3", ms),
           tdiff.make_lora_workflow("sd3", "tenantA", ms),
           tdiff.make_lora_workflow("sd3", "tenantB", ms))
    for wf in wfs:
        s.register(wf)
    adapters = {p.model_id: p for wf in wfs for node in wf.instantiate().nodes
                for p in node.op.patches}
    return s, be, adapters


def _image(s, r):
    assert r.status == "done", r.status
    return s.coordinator.engine.value_of(r.ref_key(r.graph.outputs["image"]))


def _run_mixed(s):
    reqs = [s.submit(n, inputs={"seed": sd, "prompt": "parity probe"},
                     arrival=0.0, steps=3) for n, sd in SUBS]
    s.run()
    return [_image(s, r) for r in reqs]


@pytest.fixture(scope="module")
def port_runs():
    """Folded solo runs (multilora off) and the mixed batch, fused and
    per-step, on one port ModelSet."""
    ms = tdiff.ModelSet(tdiff.FAMILIES["sd3"])
    solo = {}
    for name, seed in SUBS:
        s, be, _ = _build_port(ms, multilora=False)
        r = s.submit(name, inputs={"seed": seed, "prompt": "parity probe"},
                     steps=3)
        s.run()
        assert be.multilora_forwards == 0, "solo traffic keeps the fold path"
        solo[name] = _image(s, r)
    mixed = {}
    for fused in (True, False):
        s, be, _ = _build_port(ms, multilora=True, fused=fused)
        mixed[fused] = (_run_mixed(s), s, be)
    return solo, mixed


@pytest.mark.parametrize("fused", [True, False], ids=["segment", "per-step"])
def test_multilora_parity_single_device(port_runs, fused):
    solo, mixed = port_runs
    images, s, be = mixed[fused]
    assert any(b.multilora for b in s.coordinator.dispatch_log)
    assert be.multilora_forwards > 0
    # grouped batches never mutate the executor's folded patch state
    for ex in s.executors:
        for mid, ps in ex.patch_state.items():
            assert not ps, (mid, ps)
    for (n, _), img in zip(SUBS, images):
        d = float((img - solo[n]).abs().max())
        assert d <= PARITY_TOL, (n, d)
    # the unpatched request riding a mixed batch stays bit-exact
    torch.testing.assert_close(images[2], solo["sd3:basic"], rtol=0, atol=0)
    # adapters actually distinguish tenants
    assert float((images[0] - images[1]).abs().max()) > 1e-6


def test_multilora_parity_proc(port_runs):
    """The mixed batch on the process plane (one CPU worker): within
    ``PARITY_TOL`` of each tenant's folded solo run and bit for bit the
    in-process grouped run; both tenants' decoded factors ship once, and a
    warm second wave rides bare staged refs."""
    if not tcore.processes_available():
        pytest.skip("the host forbids spawning worker processes")
    solo, mixed = port_runs
    be = tcore.ProcBackend(tcore.ProcConfig(spawn_timeout=60.0,
                                            exec_wall_timeout=60.0),
                           device="cpu")
    s, _, _ = _build_port(tdiff.ModelSet(tdiff.FAMILIES["sd3"]),
                          multilora=True, backend=be)
    with s:
        images = _run_mixed(s)
        assert any(b.multilora for b in s.coordinator.dispatch_log)
        # both tenants' decoded factors shipped exactly once
        assert be.adapter_ships == 2 and be.adapter_hits == 0
        for (n, _), img, local in zip(SUBS, images, mixed[True][0]):
            d = float((img - solo[n]).abs().max())
            assert d <= PARITY_TOL, (n, d)
            torch.testing.assert_close(img, local, rtol=0, atol=0)
        # a warm second wave rides bare staged refs, nothing re-ships
        _run_mixed(s)
        assert be.adapter_ships == 2 and be.adapter_hits >= 2


@pytest.mark.parametrize("n_exec", [1, 4], ids=["mixed-batch", "spread"])
def test_multilora_parity_mesh(port_runs, n_exec):
    """The three tenants' requests on ``ShardedBackend`` over 4 CPU slots.
    On one executor they form a batch mixing adapters, which cannot share
    one replicated parameter set: the backend runs it on the grouped
    single-device route.  On four idle executors each request runs alone,
    its adapter folded once and the fold replicated onto the slots of its
    sharded segment.  Either way every tenant lies within ``PARITY_TOL`` of
    its folded solo run."""
    solo, _ = port_runs
    be = tcore.ShardedBackend(tcore.MeshManager(
        devices=[torch.device("cpu") for _ in range(4)]))
    s, _, _ = _build_port(tdiff.ModelSet(tdiff.FAMILIES["sd3"]),
                          multilora=True, backend=be, n_executors=n_exec)
    images = _run_mixed(s)
    if n_exec == 1:
        assert any(b.multilora for b in s.coordinator.dispatch_log)
        assert be.multilora_forwards > 0 and be.shard_log == []
    else:
        assert be.multilora_forwards == 0
        assert any(m == "segment:backbone:sd3" and k > 1
                   for m, _, k, _ in be.shard_log), be.shard_log
    for (n, _), img in zip(SUBS, images):
        d = float((img - solo[n]).abs().max())
        assert d <= PARITY_TOL, (n, d)


def test_multilora_fused_equals_unfused(port_runs):
    _, mixed = port_runs
    for got, want in zip(mixed[True][0], mixed[False][0]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    segs = [b for b in mixed[True][1].coordinator.dispatch_log if b.multilora]
    assert segs and all(b.model_id.startswith("segment:") for b in segs)


def _jax_mixed():
    s = jcore.ServingSystem(n_executors=1, backend=jcore.LocalBackend())
    s.registry = JRegistry(jcore.GraphCompiler([JInline(), JFusion(), JJit()]))
    s.coordinator.scheduler = jcore.Scheduler(
        s.profiles, use_declared_max_batch=True, multilora=True)
    ms = jdiff.ModelSet(jdiff.FAMILIES["sd3"])
    wfs = (jdiff.make_basic_workflow("sd3", ms),
           jdiff.make_lora_workflow("sd3", "tenantA", ms),
           jdiff.make_lora_workflow("sd3", "tenantB", ms))
    for wf in wfs:
        s.register(wf)
    reqs = [s.submit(n, inputs={"seed": sd, "prompt": "parity probe"},
                     arrival=0.0, steps=3) for n, sd in SUBS]
    s.run()
    assert any(b.multilora for b in s.coordinator.dispatch_log)
    return ms, [np.asarray(_image(s, r)) for r in reqs]


def test_mixed_batch_matches_jax():
    jms, want = _jax_mixed()
    ms = tdiff.ModelSet(tdiff.FAMILIES["sd3"])
    for name in ("text_enc", "backbone", "vae_dec"):
        params = getattr(jms, name).load()["params"]
        getattr(ms, name).weights = from_numpy(_numpy_tree(params))
    cfg = ms.family.toy
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    ms.latents.source = lambda seed: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))
    s, be, adapters = _build_port(ms, multilora=True)
    assert set(adapters) == {"lora:tenantA:sd3", "lora:tenantB:sd3"}
    for mid, p in adapters.items():
        name = mid.split(":")[1]
        jload = jdiff.ops.LoRAAdapter(jdiff.FAMILIES["sd3"], name).load()
        p.weights = from_numpy(_numpy_tree(jload))
    got = _run_mixed(s)
    assert be.multilora_forwards > 0
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < 1e-4


# --------------------------------------------------------------------------
# the models' own LoRA routes
# --------------------------------------------------------------------------

def test_make_lora_workflow_takes_the_family_of_its_modelset():
    """The port takes the family from ``ms`` (a full-width ModelSet gets a
    full-width patched backbone and adapter); the JAX package takes
    ``FAMILIES[family_name]`` even then.  Nothing is loaded here."""
    wide = dataclasses.replace(tdiff.SD3, toy=tdiff.REAL["sd3"])
    for ms, fam in ((tdiff.ModelSet(wide), wide), (None, tdiff.FAMILIES["sd3"])):
        wf = tdiff.make_lora_workflow("sd3", "tenantA", ms)
        assert wf.name == "sd3:lora:tenantA"
        ops = [n.op for n in wf.instantiate(steps=2).nodes]
        bb = next(op for op in ops if op.patches)
        assert bb.family is fam and bb.patches[0].family is fam
        assert bb.patches[0].model_id == "lora:tenantA:sd3"
    jwf = jdiff.make_lora_workflow(
        "sd3", "tenantA", jdiff.ModelSet(dataclasses.replace(
            jdiff.SD3, toy=CONFIGS["wide-bf16"][0])))
    jbb = next(n.op for n in jwf.instantiate(steps=2).nodes if n.op.patches)
    assert jbb.family is jdiff.FAMILIES["sd3"]          # the reference quirk


def test_lora_adapter_is_seeded_and_takes_weights():
    ad = LoRAAdapter(tdiff.SD3, "tenantA", rank=4)
    a, b = ad.load("cpu"), ad.load("cpu")
    cfg = tdiff.SD3.toy
    assert tuple(a["lora"]["wq_a"].shape) == (cfg.n_layers, cfg.d_model, 4)
    assert tuple(a["text_lora"]["a"].shape) == (cfg.text_dim, 4)
    for key in ("wq_a", "wo_b"):
        assert torch.equal(a["lora"][key], b["lora"][key])
    assert float(a["lora"]["wo_b"].abs().max()) > 0      # B randomized
    other = LoRAAdapter(tdiff.SD3, "tenantB", rank=4).load("cpu")
    assert not torch.equal(a["lora"]["wq_a"], other["lora"]["wq_a"])
    given = LoRAAdapter(tdiff.SD3, "tenantA", weights=a)
    assert given.load("cpu")["lora"]["wq_a"] is a["lora"]["wq_a"]


def test_direct_calls_fold_their_patches():
    """``_patches`` handed to ``execute_batch`` by a direct caller fold into
    a copy of the components; a batch mixing patch sets runs request by
    request.  The loaded components stay pristine."""
    fam = tdiff.FAMILIES["sd3"]
    bb = DiffusionBackbone(fam)
    comps = bb.load("cpu")
    pristine = comps["params"]["layers"]["img"]["wq"].clone()
    ad = LoRAAdapter(fam, "tenantA")
    cfg = fam.toy
    r = np.random.default_rng(0)

    def kw(patches):
        return {"latents": torch.from_numpy(r.standard_normal(
                    (1, cfg.latent_size, cfg.latent_size,
                     cfg.latent_channels)).astype(np.float32)),
                "prompt_embeds": torch.from_numpy(r.standard_normal(
                    (1, cfg.text_tokens, cfg.text_dim)).astype(np.float32)),
                "t": 0.5, "guidance": 4.5, "_patches": patches}

    patched, plain = kw([ad]), kw([])
    folded = bb.fold_patches(comps, [ad], [ad.load("cpu")])
    got = bb.execute_batch(comps, [patched, plain])
    want_p = bb.execute_batch(folded, [dict(patched, _patches=[])])[0]
    want_u = bb.execute_batch(comps, [plain])[0]
    torch.testing.assert_close(got[0]["velocity"], want_p["velocity"],
                               rtol=0, atol=0)
    torch.testing.assert_close(got[1]["velocity"], want_u["velocity"],
                               rtol=0, atol=0)
    assert not bb._batch_was_stacked
    assert torch.equal(comps["params"]["layers"]["img"]["wq"], pristine)


def test_text_encoder_multilora_matches_folded_runs():
    """The grouped text-encoder batch (adapters on the last layer's wo)
    against each adapter folded in and run alone: 1e-5 relative (one
    projection's sums in another order)."""
    fam = tdiff.FAMILIES["sd3"]
    enc = TextEncoder(fam)
    comps = enc.load("cpu")
    ads = [LoRAAdapter(fam, n) for n in ("tenantA", "tenantB")]
    pcs = {a.model_id: a.load("cpu") for a in ads}
    prompts = ["a fox", "a lighthouse at dusk", "parity probe"]
    batch = [{"prompt": p, "_patches": ps}
             for p, ps in zip(prompts, ([ads[0]], [ads[1]], []))]
    got = enc.execute_batch_multilora(comps, batch, pcs)
    for kw, out in zip(batch, got):
        solo = comps
        for p in kw["_patches"]:
            solo = enc.fold_patches(comps, [p], [pcs[p.model_id]])
        want = enc.execute(solo, prompt=kw["prompt"])["prompt_embeds"]
        assert rel_err(out["prompt_embeds"].numpy(), want.numpy()) < 1e-5
    assert not torch.equal(got[0]["prompt_embeds"],
                           enc.execute(comps, prompt=prompts[0])["prompt_embeds"])
    # no adapter in the batch: the grouped route declines
    assert enc.execute_batch_multilora(
        comps, [dict(b, _patches=[]) for b in batch], pcs) is None
