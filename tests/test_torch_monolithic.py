"""The port's monolithic baselines (``repro_torch.sim.monolithic``)
against the JAX package's: ``WorkflowSpec.from_graph`` on Table 2's S6
graphs, and ``MonolithicSystem`` in each of its three modes on one trace,
give the same fields and records exactly (the same cost model and the
same event loop; no tolerance).  Then the four cases of
``tests/test_monolithic.py`` on the port's own toy workflows."""

import dataclasses

import pytest

import repro.core as jcore
import repro.diffusion as jdiff
import repro.sim as jsim
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
import repro_torch.sim as tsim
from repro_torch.core import Model, ModelCost, TensorType, compose

PACKAGES = {"jax": (jcore, jdiff, jsim), "torch": (tcore, tdiff, tsim)}
MODES = ["diffusers", "diffusers-c", "diffusers-s"]


def _s6_specs(package):
    core, diff, sim = PACKAGES[package]
    profiles = core.ProfileStore(core.GPU_H800)
    reg = core.ServingSystem(n_executors=1)
    wfs = diff.table2_setting("s6")
    for t in wfs.values():
        reg.register(t)
    return profiles, {n: sim.WorkflowSpec.from_graph(
        reg.registry.instantiate(n), profiles) for n in wfs}


def test_workflow_spec_equals_reference():
    _, want = _s6_specs("jax")
    _, got = _s6_specs("torch")
    assert sorted(got) == sorted(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])
    # the swap of a whole workflow costs more than a second
    assert all(s.load_seconds > 1.0 for s in got.values())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("admission", [True, False])
def test_monolithic_records_equal_reference(mode, admission):
    out = {}
    for package in PACKAGES:
        profiles, specs = _s6_specs(package)
        sim = PACKAGES[package][2]
        m = sim.MonolithicSystem(4, profiles, specs, mode=mode,
                                 admission=admission)
        for t in sim.generate_trace(sorted(specs), rate=1.5, duration=120,
                                    cv=2.0, seed=1):
            m.submit(t.arrival, t.workflow, 3 * specs[t.workflow].serial_seconds_b1)
        recs = m.run()
        out[package] = ([dataclasses.astuple(r) for r in recs], m.rejected,
                        m.total_loads(), m.slo_attainment(),
                        [(g.busy_time, g.loads, g.resident) for g in m.gpus])
    assert out["torch"] == out["jax"]
    assert len(out["torch"][0]) > 50


# ---------------------------------------------------------------------------
# tests/test_monolithic.py's cases on the port (its conftest toy models,
# built on the port's Model)
# ---------------------------------------------------------------------------

class _ToyModel(Model):
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
        return ModelCost(**kw)


def _toy_workflows():
    T = TensorType()
    enc = _ToyModel("enc", [("prompt", str)], [("emb", T)],
                    {"flops_per_item": 1e11, "param_bytes": 2e9, "max_batch": 8})
    backbone = _ToyModel(
        "backbone", [("latents", T), ("emb", T), ("cn", T)], [("noise", T)],
        {"flops_per_item": 5e13, "param_bytes": 4e9, "max_parallelism": 2,
         "max_batch": 4}, deferred=("cn",))
    cn = _ToyModel("cn", [("latents", T), ("emb", T)], [("res", T)],
                   {"flops_per_item": 2.5e13, "param_bytes": 2e9,
                    "output_bytes": 1.5e8, "max_batch": 4})
    denoise = _ToyModel("denoise", [("noise", T), ("latents", T)],
                        [("latents", T)], {"flops_per_item": 1e6,
                                           "param_bytes": 0}, trivial=True)
    latgen = _ToyModel("latgen", [("seed", int)], [("latents", T)],
                       {"flops_per_item": 1e6, "param_bytes": 0}, trivial=True)
    vae = _ToyModel("vae", [("latents", T)], [("img", T)],
                    {"flops_per_item": 5e12, "param_bytes": 3e8})

    def make(name, with_cn):
        @compose(name)
        def wf_fn(wf, steps=6):
            seed = wf.add_input("seed", int)
            prompt = wf.add_input("prompt", str)
            lat = latgen(seed)
            emb = enc(prompt)
            for _ in range(steps):
                res = cn(lat, emb) if with_cn else None
                noise = backbone(lat, emb, cn=res)
                lat = denoise(noise, lat)
            img = vae(lat)
            wf.add_output(img, name="img")
        return wf_fn

    return make("toy_cn", True), make("toy_basic", False)


def _specs():
    profiles = tcore.ProfileStore(tcore.GPU_H800)
    reg = tcore.ServingSystem(n_executors=1)
    wfs = _toy_workflows()
    for wf in wfs:
        reg.register(wf)
    return profiles, {
        n: tsim.WorkflowSpec.from_graph(reg.registry.instantiate(n, steps=4),
                                        profiles)
        for n in ("toy_cn", "toy_basic")}, wfs


def test_workflow_spec_footprint():
    profiles, specs, _ = _specs()
    assert specs["toy_cn"].footprint_bytes > specs["toy_basic"].footprint_bytes
    assert specs["toy_cn"].serial_seconds_b1 > specs["toy_basic"].serial_seconds_b1


def test_static_binding_serves_only_dedicated():
    profiles, specs, _ = _specs()
    m = tsim.MonolithicSystem(2, profiles, specs, mode="diffusers")
    assert {g.dedicated_to for g in m.gpus} == {"toy_cn", "toy_basic"}
    for t in tsim.generate_trace(["toy_cn", "toy_basic"], 0.5, 60, seed=3):
        m.submit(t.arrival, t.workflow, 10.0)
    m.run()
    assert all(r.completion or r.rejected for r in m.records)


def test_swap_counts_loads():
    profiles, specs, _ = _specs()
    m = tsim.MonolithicSystem(1, profiles, specs, mode="diffusers-c",
                              admission=False)
    for i, w in enumerate(["toy_cn", "toy_basic"] * 4):
        m.submit(i * 20.0, w, None)
    m.run()
    assert m.total_loads() >= 7      # alternation forces whole-workflow swaps


def test_lego_beats_monolithic_under_pressure():
    profiles, specs, wfs = _specs()
    trace = tsim.generate_trace(["toy_cn", "toy_basic"], rate=2.5,
                                duration=90, cv=2.0, seed=4)
    lego = tcore.ServingSystem(n_executors=4, admission_enabled=True)
    for wf in wfs:
        lego.register(wf)
    solo = {n: lego.solo_latency(n, steps=4) for n in specs}
    for t in trace:
        lego.submit(t.workflow, inputs=t.inputs, arrival=t.arrival,
                    slo_seconds=2 * solo[t.workflow], steps=4)
    lego.run()
    mono = tsim.MonolithicSystem(4, profiles, specs, mode="diffusers-s")
    solo_m = {n: specs[n].serial_seconds_b1 for n in specs}
    for t in trace:
        mono.submit(t.arrival, t.workflow, 2 * solo_m[t.workflow])
    mono.run()
    assert lego.slo_attainment() >= mono.slo_attainment()
