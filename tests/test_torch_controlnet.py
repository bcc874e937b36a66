"""The ControlNet workflows (Table 2's +C.N.1 and +C.N.2) in the port
against the JAX package, on the CPU, at the toy size.

Inputs are drawn from seeds with numpy (or, for the served latents, from
the JAX package's own draw) and the JAX package's parameters are carried
across with ``from_numpy``.  The JAX package draws ``cond_embed`` with
scale 0, so a fault in the conditioning path would pass against it; every
comparison here overwrites ``cond_embed`` with a nonzero numpy draw in
both trees (normal x 1/sqrt(fan-in)).

Tolerances, and why:

* ``vae_encode``, ``controlnet_apply`` (fp32): 1e-5 relative (L2 norm of
  the difference over the norm of the JAX output); both compute in f32,
  with sums in another order;
* ``controlnet_apply`` under int8 and fp8: the bounds ``test_torch_quant``
  uses for one forward (int8 5e-3, fp8 1e-5), against the JAX package's
  quantized output;
* a stacked ``ControlNet``/``VAEEncode`` batch against single calls:
  atol = rtol = 1e-5 (the same f32 arithmetic, blocked differently);
* fused ``DenoiseSegment`` against the unfused per-step chain: bit for bit
  (``rtol=0, atol=0``), within the port;
* the served images against the JAX package's: 1e-4 relative, as
  ``tests/test_torch_serving.py`` holds the basic workflow;
* the grouped multi-LoRA segment with a ControlNet against each tenant's
  folded solo run: ``PARITY_TOL`` = 2e-4 max-abs, the JAX package's
  multi-tenant gate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.diffusion as jdiff
import repro.diffusion.ops as jops
from repro.diffusion import config as jcfg
from repro.diffusion import encoders as je
from repro.diffusion import mmdit as jm
from repro.nn import layers as jlayers
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
from repro_torch.core.passes import (
    AsyncLoRAPass,
    InlineTrivialPass,
    JitCompilePass,
    default_passes,
)
from repro_torch.core.types import Image
from repro_torch.diffusion import config as tcfg
from repro_torch.diffusion import encoders as te
from repro_torch.diffusion import mmdit as tm
from repro_torch.diffusion.ops import (
    ControlNet,
    DenoiseSegment,
    LoRAAdapter,
    VAEDecode,
    VAEEncode,
)
from repro_torch.diffusion.sampler import flow_schedule
from repro_torch.nn import layers as tlayers
from repro_torch.weights import from_numpy

WIDE = dict(d_model=128, n_layers=2, n_heads=2, d_ff=256, text_dim=96,
            latent_size=8, latent_channels=16, patch=2, text_tokens=5)
DEEP = dict(n_layers=4)
CONFIGS = {   # name: (JAX config, port config, n_cn_layers)
    "toy": (jcfg._TOY, tcfg._TOY, None),
    "toy-4-layers-3-cn": (dataclasses.replace(jcfg._TOY, **DEEP),
                          dataclasses.replace(tcfg._TOY, **DEEP), 3),
    "wide-bf16": (jcfg.DiTConfig(**WIDE, dtype=jnp.bfloat16),
                  tcfg.DiTConfig(**WIDE, dtype=torch.bfloat16), None),
}
FWD_TOL = {"int8": 5e-3, "fp8": 1e-5}
PARITY_TOL = 2e-4
UNFUSED = [InlineTrivialPass(), AsyncLoRAPass(), JitCompilePass()]


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _live_cond(params, seed=5):
    """The JAX tree with a nonzero ``cond_embed`` (normal / sqrt(fan-in),
    in the tree's dtype)."""
    ce = params["cond_embed"]
    w = np.random.default_rng(seed).standard_normal(ce.shape) / np.sqrt(
        ce.shape[0])
    return {**params, "cond_embed": jnp.asarray(w, jnp.float32).astype(ce.dtype)}


def _cn_inputs(cfg, b=2, seed=0):
    r = np.random.default_rng(seed)
    shape = (b, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    lat = r.standard_normal(shape).astype(np.float32)
    cond = r.standard_normal(shape).astype(np.float32)
    t = np.linspace(0.9, 0.25, b).astype(np.float32)
    emb = r.standard_normal((b, cfg.text_tokens, cfg.text_dim)).astype(np.float32)
    return lat, cond, t, emb


def _ref_image(seed=0, size=128):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (1, size, size, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 37, 50)],
                         ids=["even", "odd"])
def test_vae_encode_matches_jax(shape):
    """Three stride-2 SAME convs: XLA pads (0, 1) on an even input and
    (1, 1) on an odd one."""
    params = je.init_vae(jax.random.PRNGKey(0), latent_channels=4)
    img = np.random.default_rng(1).uniform(-1, 1, shape + (3,)).astype(
        np.float32)
    want = je.vae_encode(params, jnp.asarray(img))
    got = te.vae_encode(from_numpy(_numpy_tree(params)), torch.from_numpy(img))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("name", list(CONFIGS))
def test_controlnet_apply_matches_jax(name):
    jc, tc, n_cn = CONFIGS[name]
    jparams = _live_cond(jm.init_controlnet(jax.random.PRNGKey(3), jc, n_cn))
    tparams = from_numpy(_numpy_tree(jparams))
    want_cn = n_cn or max(1, jc.n_layers // 2)
    assert tparams["zero_proj"].shape == (want_cn, jc.d_model, jc.d_model)
    assert tparams["layers"]["img"]["wq"].dtype == tc.dtype
    inputs = _cn_inputs(jc)
    want = jm.controlnet_apply(jparams, jc, *map(jnp.asarray, inputs))
    got = tm.controlnet_apply(tparams, tc, *map(torch.from_numpy, inputs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert tuple(got.shape) == (jc.n_layers, 2, jc.image_tokens, jc.d_model)
    assert want_cn < jc.n_layers and not bool(got[want_cn:].any())  # zero pad
    assert rel_err(got.numpy(), want) < 1e-5
    # the conditioning path is live: another cond moves the residuals
    other = tm.controlnet_apply(tparams, tc, *map(torch.from_numpy, (
        inputs[0], -inputs[1], inputs[2], inputs[3])))
    assert rel_err(other.numpy(), want) > 1e-2


def test_init_controlnet_tree_matches_jax():
    """Leaf for leaf: the same keys, shapes and dtypes, ``cond_embed`` all
    zeros, drawn on the generator's device."""
    jc, tc, _ = CONFIGS["wide-bf16"]
    jt = _numpy_tree(jm.init_controlnet(jax.random.PRNGKey(0), jc))
    tt = tm.init_controlnet(torch.Generator().manual_seed(0), tc)
    jl = jax.tree_util.tree_flatten_with_path(jt)[0]
    tl = jax.tree_util.tree_flatten_with_path(
        tt, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).replace("torch.", "") == a.dtype.name, path
    assert not bool(tt["cond_embed"].any())
    assert bool(tt["zero_proj"].any())


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_controlnet_apply_quantized_matches_jax(mode):
    jc, tc = jdiff.FAMILIES["sd3"].toy, tdiff.FAMILIES["sd3"].toy
    params = _live_cond(jm.init_controlnet(jax.random.PRNGKey(11), jc))
    tparams = from_numpy(_numpy_tree(params))
    inputs = _cn_inputs(jc)
    prev = (jlayers.set_quant_mode(mode), tlayers.set_quant_mode(mode))
    try:
        jqp = jm.quantize_mmdit_params(params)
        tqp = tm.quantize_mmdit_params(tparams)
    finally:
        jlayers.set_quant_mode(prev[0])
        tlayers.set_quant_mode(prev[1])
    # the stream projections quantize; zero_proj and the embeddings do not
    assert set(tqp["layers"]["img"]["wq"]) == {"qw", "qs"}
    assert tqp["zero_proj"] is tparams["zero_proj"]
    assert tqp["cond_embed"] is tparams["cond_embed"]
    off = jm.controlnet_apply(params, jc, *map(jnp.asarray, inputs))
    want = jm.controlnet_apply(jqp, jc, *map(jnp.asarray, inputs))
    got = tm.controlnet_apply(tqp, tc, *map(torch.from_numpy, inputs))
    assert rel_err(got.numpy(), want) <= FWD_TOL[mode]
    assert rel_err(got.numpy(), off) > FWD_TOL[mode]


def test_controlnet_batch_equals_single_calls():
    fam = tdiff.FAMILIES["sd3"]
    cn = ControlNet(fam, 1)
    comps = cn.load("cpu")
    lat, cond, _, emb = _cn_inputs(fam.toy, b=2, seed=3)
    kws = [{"latents": torch.from_numpy(lat[i:i + 1]),
            "cond_latents": torch.from_numpy(cond[i:i + 1]),
            "prompt_embeds": torch.from_numpy(emb[i:i + 1]),
            "t": 0.5 + 0.2 * i} for i in range(2)]
    batched = cn.execute_batch(comps, kws)
    for kw, got in zip(kws, batched):
        want = cn.execute(comps, **kw)["controlnet_residuals"]
        got = got["controlnet_residuals"]
        assert tuple(got.shape) == (fam.toy.n_layers, 1, fam.toy.image_tokens,
                                    fam.toy.d_model)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(batched[0]["controlnet_residuals"],
                              batched[1]["controlnet_residuals"])
    # a batch whose latent shapes disagree runs request by request
    odd = dict(kws[1], latents=torch.zeros((2,) + tuple(lat.shape[1:])),
               cond_latents=torch.zeros((2,) + tuple(lat.shape[1:])),
               prompt_embeds=torch.zeros((2,) + tuple(emb.shape[1:])))
    mixed = cn.execute_batch(comps, [kws[0], odd])
    assert mixed[1]["controlnet_residuals"].shape[1] == 2


def test_vae_encode_shares_the_decoders_components():
    """``VAEEncode`` has ``VAEDecode``'s model id, so the executor may hand
    it whichever loaded first: both load the same components from the same
    weights.  A stacked batch equals single calls, and an image without a
    shape becomes the zero stand-in of the family's pixel size."""
    fam = tdiff.FAMILIES["sd3"]
    weights = VAEDecode(fam).load("cpu")["params"]
    enc, dec = VAEEncode(fam, weights), VAEDecode(fam, weights)
    assert enc.model_id == dec.model_id == "vae:sd3"
    ce, cd = enc.load("cpu"), dec.load("cpu")
    assert set(ce) == set(cd)
    for a, b in zip(jax.tree.leaves(ce["params"]), jax.tree.leaves(cd["params"])):
        assert torch.equal(a, b)
    imgs = [_ref_image(i) for i in range(2)]
    batched = enc.execute_batch(cd, [{"image": im} for im in imgs])
    for im, got in zip(imgs, batched):
        want = enc.execute(ce, image=torch.from_numpy(im))["cond_latents"]
        assert tuple(got["cond_latents"].shape) == (1, 16, 16, 4)
        torch.testing.assert_close(got["cond_latents"], want, atol=1e-5,
                                   rtol=1e-5)
    blank = enc.execute(ce, image=None)["cond_latents"]
    torch.testing.assert_close(
        blank, enc.execute(ce, image=torch.zeros((1, 128, 128, 3)))[
            "cond_latents"], rtol=0, atol=0)


@pytest.mark.parametrize("family_name", ["sd3", "flux-dev"])
def test_costs_match_jax(family_name):
    """The profiles price with ``cost()``: each new model's, and a segment's
    with one and two ControlNets, equal the JAX package's field for field."""
    jms = jdiff.ModelSet(jdiff.FAMILIES[family_name])
    tms = tdiff.ModelSet(tdiff.FAMILIES[family_name])
    for name in ("cn1", "cn2", "vae_enc", "combine"):
        assert vars(getattr(tms, name).cost()) == vars(
            getattr(jms, name).cost()), name
    for n in (1, 2):
        jseg = jms.backbone.build_segment([jms.cn1, jms.cn2][:n], 4)
        tseg = tms.backbone.build_segment([tms.cn1, tms.cn2][:n], 4)
        assert tseg.model_id == jseg.model_id
        assert vars(tseg.cost()) == vars(jseg.cost())


# --------------------------------------------------------------------------
# served workflows
# --------------------------------------------------------------------------

def _images(system, reqs):
    assert all(r.status == "done" for r in reqs)
    return [system.coordinator.engine.value_of(
        r.ref_key(r.graph.outputs["image"])) for r in reqs]


def _serve_port(wf, inputs, steps, fused=True, segment_chunk=None):
    system = tcore.ServingSystem(
        n_executors=2, backend=tcore.LocalBackend(device="cpu"))
    if not fused:
        system.registry.compiler = tcore.GraphCompiler(list(UNFUSED))
    if segment_chunk is not None:
        system.coordinator.scheduler = tcore.Scheduler(
            system.profiles, use_declared_max_batch=True,
            segment_chunk=segment_chunk)
    system.register(wf)
    reqs = [system.submit(wf.name, inputs=dict(inp), arrival=0.0, steps=steps)
            for inp in inputs]
    system.run()
    return _images(system, reqs), system


@pytest.mark.parametrize("family_name", ["sd3", "flux-schnell"])
@pytest.mark.parametrize("n_cns", [1, 2])
def test_segment_with_controlnets_equals_unfused_bitexact(family_name, n_cns):
    """steps=5 puts non-dyadic dt values on the schedule; the chunked run
    (4 + 1 steps) restarts the ControlNets mid-schedule.  One request per
    run, as the JAX package's test: a CPU GEMM's bits depend on how many
    rows it is given, and the unfused scheduler batches the per-step
    ControlNet nodes of two requests differently from the segment."""
    ms = tdiff.ModelSet(tdiff.FAMILIES[family_name])
    wf = tdiff.make_controlnet_workflow(family_name, n_cns, ms)
    inputs = [{"seed": 2, "prompt": "cn probe", "ref_image": _ref_image(2)}]
    unfused, sys_u = _serve_port(wf, inputs, steps=5, fused=False)
    full, sys_f = _serve_port(wf, inputs, steps=5)
    runs = [full]
    if family_name == "sd3":
        chunk4, sys_c4 = _serve_port(wf, inputs, steps=5, segment_chunk=4)
        runs.append(chunk4)
        segs = [d.segment_steps for d in sys_c4.coordinator.dispatch_log
                if d.model_id.startswith("segment:")]
        assert segs == [4, 1], segs
    for got in runs:
        torch.testing.assert_close(got[0], unfused[0], rtol=0, atol=0)
    cn_ids = "".join(f"+controlnet{i + 1}:{family_name}" for i in range(n_cns))
    fused_ids = {m for m, _ in sys_f.coordinator.backend.forward_log}
    assert f"segment:backbone:{family_name}{cn_ids}" in fused_ids
    assert not any(m.startswith("controlnet") for m in fused_ids)
    unfused_ids = {m for m, _ in sys_u.coordinator.backend.forward_log}
    assert {f"controlnet{i + 1}:{family_name}"
            for i in range(n_cns)} <= unfused_ids


def test_fusion_gives_the_controlnets_the_backbones_time():
    """The unfused ControlNet node takes ``t = t_cur``, the backbone the
    same; the segment's ``t_mid`` feeds both, so they must agree."""
    ms = tdiff.ModelSet(tdiff.SD3)
    wf = tdiff.make_controlnet_workflow("sd3", 2, ms)
    plain = tcore.GraphCompiler(list(UNFUSED)).compile(wf.instantiate(steps=3))
    ts = {}
    for n in plain.nodes:
        if n.op.model_id in ("backbone:sd3", "controlnet1:sd3",
                             "controlnet2:sd3"):
            ts.setdefault(n.op.model_id, []).append(float(n.inputs["t"]))
    assert ts["controlnet1:sd3"] == ts["controlnet2:sd3"] == ts["backbone:sd3"]
    fused = tcore.GraphCompiler(default_passes()).compile(wf.instantiate(steps=3))
    (seg,) = [n for n in fused.nodes if n.op.model_id.startswith("segment:")]
    assert list(seg.inputs["t_mid"]) == ts["backbone:sd3"]
    assert [cn.model_id for cn in seg.op.cns] == ["controlnet1:sd3",
                                                  "controlnet2:sd3"]
    assert "cond_latents" in seg.inputs


@pytest.fixture
def live_cond_jax(monkeypatch):
    """The JAX package's ControlNet draws a nonzero ``cond_embed`` for the
    duration of a test (its own init, then the overwrite)."""
    real = jops.init_controlnet
    monkeypatch.setattr(jops, "init_controlnet",
                        lambda key, cfg, *a: _live_cond(real(key, cfg, *a)))


def _port_modelset_from_jax(jms):
    """A port ModelSet carrying the JAX package's weights and latents."""
    ms = tdiff.ModelSet(tdiff.FAMILIES[jms.family.name])
    for name in ("text_enc", "backbone", "vae_dec", "vae_enc", "cn1", "cn2"):
        params = getattr(jms, name).load()["params"]
        getattr(ms, name).weights = from_numpy(_numpy_tree(params))
    cfg = ms.family.toy
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    ms.latents.source = lambda seed: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))
    return ms


@pytest.mark.parametrize("n_cns", [1, 2])
def test_served_controlnet_image_matches_jax(live_cond_jax, n_cns):
    inputs = [{"seed": 0, "prompt": "a fox", "ref_image": _ref_image(0)},
              {"seed": 1, "prompt": "two foxes", "ref_image": _ref_image(1)}]
    jms = jdiff.ModelSet(jdiff.FAMILIES["sd3"])
    assert bool(np.asarray(jms.cn1.load()["params"]["cond_embed"]).any())
    jsys = jcore.ServingSystem(n_executors=2, backend=jcore.LocalBackend())
    jwf = jdiff.make_controlnet_workflow("sd3", n_cns, jms)
    jsys.register(jwf)
    jreqs = [jsys.submit(jwf.name, inputs=dict(inp), arrival=0.0, steps=4)
             for inp in inputs]
    jsys.run()
    want = [np.asarray(x) for x in _images(jsys, jreqs)]
    ms = _port_modelset_from_jax(jms)
    got, system = _serve_port(tdiff.make_controlnet_workflow("sd3", n_cns, ms),
                              inputs, steps=4)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert rel_err(g.numpy(), w) < 1e-4
    assert any(m.startswith("segment:backbone:sd3+controlnet1:sd3")
               for m, _ in system.coordinator.backend.forward_log)
    # the reference image reaches the image: another one moves it
    other, _ = _serve_port(tdiff.make_controlnet_workflow("sd3", n_cns, ms),
                           [dict(inputs[0], ref_image=-inputs[0]["ref_image"])],
                           steps=4)
    assert rel_err(other[0].numpy(), want[0]) > 1e-3


@pytest.mark.parametrize("setting", ["s1", "s3", "s5", "s6"])
def test_table2_setting_matches_jax(setting):
    """The same workflow names, and the same model ids node for node, both
    as composed and after the default passes (so sharing across workflows
    is by the same ids)."""
    jwfs, twfs = jdiff.table2_setting(setting), tdiff.table2_setting(setting)
    assert list(twfs) == list(jwfs)
    for name, jwf in jwfs.items():
        twf = twfs[name]
        assert ([n.op.model_id for n in twf.instantiate(steps=3).nodes]
                == [n.op.model_id for n in jwf.instantiate(steps=3).nodes])
        jg = jcore.GraphCompiler(jcore.default_passes()).compile(
            jwf.instantiate(steps=3))
        tg = tcore.GraphCompiler(default_passes()).compile(
            twf.instantiate(steps=3))
        assert ([n.op.model_id for n in tg.nodes]
                == [n.op.model_id for n in jg.nodes])
        if ":cn" in name:
            assert twf.instantiate(steps=2).inputs["ref_image"].type is Image


def test_table2_setting_takes_given_model_sets():
    wide = dataclasses.replace(tdiff.SD3, toy=tdiff.REAL["sd3"])
    ms = tdiff.ModelSet(wide)
    wfs = tdiff.table2_setting("s5", model_sets={"sd3": ms})
    assert list(wfs) == ["sd3:basic", "sd3:cn1", "sd3:cn2", "sd3.5-large:basic",
                         "sd3.5-large:cn1", "sd3.5-large:cn2"]
    nodes = wfs["sd3:cn2"].instantiate(steps=2).nodes
    assert {n.op.family.toy.d_model for n in nodes
            if hasattr(n.op, "family")} == {1536}
    nodes = wfs["sd3.5-large:cn1"].instantiate(steps=2).nodes
    assert {n.op.family.toy.d_model for n in nodes
            if hasattr(n.op, "family")} == {64}


# --------------------------------------------------------------------------
# the grouped multi-LoRA route carries the residuals
# --------------------------------------------------------------------------

def test_grouped_segment_with_controlnet_matches_folded_solo_runs():
    """A segment batch of two LoRA tenants, each with its own reference
    image, on the grouped route against each tenant's adapter folded in and
    run alone; a segment without the ControlNet is the control."""
    fam = tdiff.FAMILIES["sd3"]
    cfg = fam.toy
    ms = tdiff.ModelSet(fam)
    seg = DenoiseSegment(ms.backbone, [ms.cn1], n_steps=3)
    bare = DenoiseSegment(ms.backbone, [], n_steps=3)
    comps, bare_comps = seg.load("cpu"), bare.load("cpu")
    ads = [LoRAAdapter(fam, "tenantA"), LoRAAdapter(fam, "tenantB")]
    adapters = {a.model_id: a.load("cpu") for a in ads}
    sched = [float(x) for x in flow_schedule(3)]
    r = np.random.default_rng(7)
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    batch = [{"latents": torch.from_numpy(r.standard_normal(shape).astype(np.float32)),
              "prompt_embeds": torch.from_numpy(r.standard_normal(
                  (1, cfg.text_tokens, cfg.text_dim)).astype(np.float32)),
              "cond_latents": torch.from_numpy(r.standard_normal(shape).astype(np.float32)),
              "t_mid": tuple(sched[:3]), "t_cur": tuple(sched[:3]),
              "t_next": tuple(sched[1:]), "guidance": 4.5,
              "_patches": [a]} for a in ads]
    grouped = seg.execute_batch_multilora(comps, batch, adapters)
    assert grouped is not None
    no_cn = bare.execute_batch_multilora(
        bare_comps, [{k: v for k, v in kw.items() if k != "cond_latents"}
                     for kw in batch], adapters)
    for kw, a, got, ctl in zip(batch, ads, grouped, no_cn):
        folded = seg.fold_patches(comps, [a], [adapters[a.model_id]])
        solo = seg.execute_batch(folded, [{k: v for k, v in kw.items()
                                           if k != "_patches"}])[0]
        d = float((got["latents"] - solo["latents"]).abs().max())
        assert d <= PARITY_TOL, (a.model_id, d)
        assert float((ctl["latents"] - solo["latents"]).abs().max()) > PARITY_TOL
    assert float((grouped[0]["latents"]
                  - grouped[1]["latents"]).abs().max()) > 1e-6
