"""The port's coordinator under crash-and-revive fault schedules: every
request terminates exactly once, checked with the reference package's
serving-system invariants on the same toy workflow."""

import pytest

import repro_torch.core as tcore
from repro.sim import check_invariants


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
