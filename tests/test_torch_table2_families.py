"""Table 2's ControlNet, LoRA and int8 workflows of the SD3.5-Large and
Flux families, served through the port and through the JAX package on
the CPU, on carried weights and the JAX package's latents.

* The ControlNet workflows (+C.N.1, +C.N.2) at narrow widths that keep
  each family's published head dim: flux-schnell at d 256 with 2 heads
  of 128 (no CFG rows), sd3.5-large at d 192 with an odd head count, 3
  heads of 64 (CFG rows); the JAX side runs its Pallas kernel in
  interpret mode there, the port's joint attention takes the flash
  route's plain version.  Both ControlNets carry a nonzero
  ``cond_embed`` (the JAX package draws it at scale 0, with which a
  fault in the conditioning path would pass).
* flux-schnell's mixed LoRA batch (two tenants and a basic request in
  one grouped forward): without CFG rows a request is one row of the
  batch, so the row-to-adapter index is not SD3's doubled one.
* flux-schnell's int8 served image against the JAX package's int8 image.
* The layer-by-layer quantization of a stacked leaf against the whole
  leaf's, bit for bit.

Tolerances: the f32 images within 1e-4 relative (L2 norm of the
difference over the norm of the JAX image), as ``test_torch_serving.py``
holds the basic workflow; the int8 image within 2.5e-2, the bound of
``test_torch_quant_serving.py`` (int8 is not continuous in its input:
the two packages' f32 activations differ in the last bits, and a
flipped rounding moves the image by about 2e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.diffusion as jdiff
import repro.diffusion.ops as jops
from repro.core.passes import InlineTrivialPass as JInline
from repro.core.passes import JitCompilePass as JJit
from repro.core.passes import SegmentFusionPass as JFusion
from repro.core.registry import WorkflowRegistry as JRegistry
from repro.kernels.quant_matmul import ops as jq
from repro.nn import layers as jlayers
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
from repro_torch.core.passes import (
    InlineTrivialPass,
    JitCompilePass,
    SegmentFusionPass,
)
from repro_torch.core.registry import WorkflowRegistry
from repro_torch.kernels.quant_matmul import ops as tq
from repro_torch.nn import layers as tlayers
from repro_torch.weights import from_numpy

F32_TOL = 1e-4
INT8_TOL = 2.5e-2
NARROW = {   # family: the toy DiT widened to keep the published head dim
    "flux-schnell": dict(d_model=256, n_layers=2, n_heads=2, d_ff=1024),
    "sd3.5-large": dict(d_model=192, n_layers=2, n_heads=3, d_ff=768),
}
HEAD_DIM = {"flux-schnell": 128, "sd3.5-large": 64}
MIXED = [("flux-schnell:lora:tenantA", 3), ("flux-schnell:lora:tenantB", 4),
         ("flux-schnell:basic", 5)]
STEPS = 3
MODELS = ("text_enc", "backbone", "vae_dec", "vae_enc", "cn1", "cn2")


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _images(system, reqs):
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return [system.coordinator.engine.value_of(
        r.ref_key(r.graph.outputs["image"])) for r in reqs]


def _ref_image(seed, size):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (1, size, size, 3)).astype(np.float32)


def _families(name):
    """The JAX package's and the port's family at the narrow width."""
    jfam, tfam = jdiff.FAMILIES[name], tdiff.FAMILIES[name]
    return (dataclasses.replace(jfam, toy=dataclasses.replace(
                jfam.toy, **NARROW[name])),
            dataclasses.replace(tfam, toy=dataclasses.replace(
                tfam.toy, **NARROW[name])))


def _port_modelset(jms, family, names=MODELS):
    """A port ModelSet of ``family`` carrying the JAX ModelSet's weights
    (those of ``names``) and the JAX package's latents."""
    ms = tdiff.ModelSet(family)
    for name in names:
        params = getattr(jms, name).load()["params"]
        getattr(ms, name).weights = from_numpy(jax.tree.map(np.asarray, params))
    cfg = family.toy
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    ms.latents.source = lambda seed: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))
    return ms


@pytest.fixture
def live_cond_jax(monkeypatch):
    """The JAX package's ControlNets draw a nonzero ``cond_embed`` (normal
    over sqrt(fan-in), in the tree's dtype) for the test's duration."""
    real = jops.init_controlnet

    def live(key, cfg, *a):
        params = real(key, cfg, *a)
        ce = params["cond_embed"]
        w = np.random.default_rng(5).standard_normal(ce.shape) / np.sqrt(
            ce.shape[0])
        return {**params,
                "cond_embed": jnp.asarray(w, jnp.float32).astype(ce.dtype)}

    monkeypatch.setattr(jops, "init_controlnet", live)


@pytest.mark.parametrize("n_cns", [1, 2])
@pytest.mark.parametrize("name", ["flux-schnell", "sd3.5-large"])
def test_served_controlnet_image_matches_jax(live_cond_jax, monkeypatch,
                                             name, n_cns):
    """One +C.N.n request of the family through both packages: the image
    within 1e-4, the denoising loop fused with its ControlNets into one
    segment, every joint attention at the family's head dim, and another
    reference image moves the port's image."""
    jfam, family = _families(name)
    assert family.toy.head_dim == HEAD_DIM[name]
    size = 8 * family.toy.latent_size
    inp = {"seed": 0, "prompt": "a fox", "ref_image": _ref_image(0, size)}
    jms = jdiff.ModelSet(jfam)
    assert bool(np.asarray(jms.cn1.load()["params"]["cond_embed"]).any())
    jsys = jcore.ServingSystem(n_executors=1, backend=jcore.LocalBackend())
    jwf = jdiff.make_controlnet_workflow(name, n_cns, jms)
    jsys.register(jwf)
    jreq = jsys.submit(jwf.name, inputs=dict(inp), arrival=0.0, steps=STEPS)
    jsys.run()
    want = np.asarray(_images(jsys, [jreq])[0])

    from repro_torch.kernels.flash_attention import ops as fa_ops
    head_dims = []
    real_mha = fa_ops.mha

    def spy(q, k, v, **kw):
        head_dims.append(q.shape[-1])
        return real_mha(q, k, v, **kw)

    monkeypatch.setattr(fa_ops, "mha", spy)
    ms = _port_modelset(jms, family)
    wf = tdiff.make_controlnet_workflow(name, n_cns, ms)
    served = []
    for ref in (inp["ref_image"], -inp["ref_image"]):
        system = tcore.ServingSystem(
            n_executors=1, backend=tcore.LocalBackend(device="cpu"))
        system.register(wf)
        req = system.submit(wf.name, inputs=dict(inp, ref_image=ref),
                            arrival=0.0, steps=STEPS)
        system.run()
        served.append(_images(system, [req])[0])
        if len(served) == 1:
            cns = "".join(f"+controlnet{i + 1}:{name}" for i in range(n_cns))
            assert {m for m, _ in system.coordinator.backend.forward_log} >= {
                f"segment:backbone:{name}{cns}"}
    got = served[0]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < F32_TOL
    assert HEAD_DIM[name] in head_dims
    assert set(head_dims) <= {HEAD_DIM[name], family.toy.text_dim // 4}
    assert rel_err(served[1].numpy(), want) > 1e-3


def _jax_mixed(name):
    s = jcore.ServingSystem(n_executors=1, backend=jcore.LocalBackend())
    s.registry = JRegistry(jcore.GraphCompiler([JInline(), JFusion(), JJit()]))
    s.coordinator.scheduler = jcore.Scheduler(
        s.profiles, use_declared_max_batch=True, multilora=True)
    jms = jdiff.ModelSet(jdiff.FAMILIES[name])
    for wf in (jdiff.make_basic_workflow(name, jms),
               jdiff.make_lora_workflow(name, "tenantA", jms),
               jdiff.make_lora_workflow(name, "tenantB", jms)):
        s.register(wf)
    reqs = [s.submit(n, inputs={"seed": sd, "prompt": "parity probe"},
                     arrival=0.0, steps=STEPS) for n, sd in MIXED]
    s.run()
    assert any(b.multilora for b in s.coordinator.dispatch_log)
    return jms, [np.asarray(x) for x in _images(s, reqs)]


def test_flux_mixed_lora_batch_matches_jax(monkeypatch):
    """flux-schnell's two tenants and a basic request in one grouped
    forward per step: each image within 1e-4 of the JAX package's mixed
    batch, and the image stream's per-row adapter index one row a request
    (tenant A, tenant B, none), where SD3's CFG doubles it."""
    name = "flux-schnell"
    jms, want = _jax_mixed(name)
    family = tdiff.FAMILIES[name]
    ms = _port_modelset(jms, family, names=("text_enc", "backbone", "vae_dec"))
    s = tcore.ServingSystem(n_executors=1,
                            backend=tcore.LocalBackend(device="cpu"))
    s.registry = WorkflowRegistry(tcore.GraphCompiler(
        [InlineTrivialPass(), SegmentFusionPass(), JitCompilePass()]))
    s.coordinator.scheduler = tcore.Scheduler(
        s.profiles, use_declared_max_batch=True, multilora=True)
    wfs = (tdiff.make_basic_workflow(name, ms),
           tdiff.make_lora_workflow(name, "tenantA", ms),
           tdiff.make_lora_workflow(name, "tenantB", ms))
    for wf in wfs:
        s.register(wf)
    for p in {p for wf in wfs for n in wf.instantiate().nodes
              for p in n.op.patches}:
        lora = p.model_id.split(":")[1]
        p.weights = from_numpy(jax.tree.map(
            np.asarray, jops.LoRAAdapter(jdiff.FAMILIES[name], lora).load()))
    rows = []
    real = tlayers.lora_apply_grouped

    def spy(x2, w, a, b, idx, scales):
        rows.append(idx.clone())
        return real(x2, w, a, b, idx, scales)

    monkeypatch.setattr(tlayers, "lora_apply_grouped", spy)
    reqs = [s.submit(n, inputs={"seed": sd, "prompt": "parity probe"},
                     arrival=0.0, steps=STEPS) for n, sd in MIXED]
    s.run()
    got = _images(s, reqs)
    assert s.coordinator.backend.multilora_forwards > 0
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < F32_TOL
    ti = family.toy.image_tokens
    image_rows = [r for r in rows if r.numel() == 3 * ti]
    assert image_rows, [r.numel() for r in rows]
    pattern = torch.tensor([0, 1, -1], dtype=torch.int32).repeat_interleave(ti)
    assert all(torch.equal(r, pattern) for r in image_rows)
    # 4 targets a layer a step of the one segment dispatch
    assert len(image_rows) == 4 * family.toy.n_layers * STEPS


def test_flux_int8_served_image_matches_jax():
    """flux-schnell:basic under int8 in both packages, the JAX package's
    quantized weights carried across: within the int8 bound of its int8
    image, and every stream and text projection ran the int8 product."""
    name = "flux-schnell"
    inp = {"seed": 0, "prompt": "a fox"}
    prev = (jlayers.set_quant_mode("int8"), tlayers.set_quant_mode("int8"))
    calls = []
    real = tq.quant_matmul

    def counted(*args):
        calls.append(tuple(args[0].shape) + (args[1].shape[1],))
        return real(*args)

    try:
        jsys = jcore.ServingSystem(n_executors=1, backend=jcore.LocalBackend())
        jms = jdiff.ModelSet(jdiff.FAMILIES[name])
        jsys.register(jdiff.make_basic_workflow(name, jms))
        jreq = jsys.submit(f"{name}:basic", inputs=dict(inp), arrival=0.0,
                           steps=STEPS)
        jsys.run()
        want = np.asarray(_images(jsys, [jreq])[0])
        ms = _port_modelset(jms, tdiff.FAMILIES[name],
                            names=("text_enc", "backbone", "vae_dec"))
        assert set(ms.backbone.weights["layers"]["img"]["w1"]) == {"qw", "qs"}
        tq.quant_matmul = counted
        system = tcore.ServingSystem(
            n_executors=1, backend=tcore.LocalBackend(device="cpu"))
        system.register(tdiff.make_basic_workflow(name, ms))
        req = system.submit(f"{name}:basic", inputs=dict(inp), arrival=0.0,
                            steps=STEPS)
        system.run()
    finally:
        tq.quant_matmul = real
        jlayers.set_quant_mode(prev[0])
        tlayers.set_quant_mode(prev[1])
    got = _images(system, [req])[0].numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= INT8_TOL
    cfg = tdiff.FAMILIES[name].toy
    # 7 a stream and layer a step (no CFG rows: M is one request's tokens),
    # 6 a text-encoder layer
    assert len(calls) == STEPS * cfg.n_layers * 2 * 7 + 2 * 6
    assert (1, cfg.d_model, 6 * cfg.d_model) in calls
    assert (cfg.image_tokens, cfg.d_model, cfg.d_ff) in calls


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(4, 64, 96), (3, 2, 40, 24), (64, 96)])
def test_layerwise_quantization_equals_the_whole_leaf(mode, shape):
    """A stacked leaf quantized a matrix at a time gives the whole leaf's
    bits: the port's own whole-leaf route and the JAX package's."""
    r = np.random.default_rng(sum(shape))
    w = (r.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 3] = 0.0                               # an all-zero channel
    tw = torch.from_numpy(w).to(torch.bfloat16)
    got = tq.quantize_weight(tw, mode)
    whole = tq._quantize_matrix(tw, mode)
    want = jq.quantize_weight(jnp.asarray(w).astype(jnp.bfloat16), mode)
    assert got["qw"].dtype == whole["qw"].dtype
    assert tuple(got["qs"].shape) == shape[:-2] + (1, shape[-1])
    bits = {k: got[k].view(torch.uint8) if got[k].element_size() == 1
            else got[k] for k in got}
    assert torch.equal(bits["qw"], whole["qw"].view(torch.uint8))
    assert torch.equal(bits["qs"], whole["qs"])
    want_qw = np.asarray(want["qw"]).view(np.uint8)
    assert np.array_equal(bits["qw"].numpy(), want_qw)
    assert np.array_equal(got["qs"].numpy(), np.asarray(want["qs"]))
