"""Shared test fixtures: toy diffusion-shaped models for the sim plane."""

import pytest

from repro.core import Model, ModelCost, TensorType, compose


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where none is present")


class _ToyModel(Model):
    """Parametrizable sim-plane model (no real compute)."""

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


@pytest.fixture
def toy_models():
    T = TensorType()
    enc = _ToyModel("enc", [("prompt", str)], [("emb", T)],
                    {"flops_per_item": 1e11, "param_bytes": 2e9, "max_batch": 8})
    backbone = _ToyModel(
        "backbone",
        [("latents", T), ("emb", T), ("cn", T)],
        [("noise", T)],
        {"flops_per_item": 5e13, "param_bytes": 4e9, "max_parallelism": 2,
         "max_batch": 4},
        deferred=("cn",),
    )
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
    return dict(enc=enc, backbone=backbone, cn=cn, denoise=denoise,
                latgen=latgen, vae=vae)


@pytest.fixture
def toy_workflow(toy_models):
    m = toy_models

    @compose("toy_cn")
    def wf_fn(wf, steps=6):
        seed = wf.add_input("seed", int)
        prompt = wf.add_input("prompt", str)
        lat = m["latgen"](seed)
        emb = m["enc"](prompt)
        for _ in range(steps):
            res = m["cn"](lat, emb)
            noise = m["backbone"](lat, emb, cn=res)
            lat = m["denoise"](noise, lat)
        img = m["vae"](lat)
        wf.add_output(img, name="img")

    return wf_fn


@pytest.fixture
def toy_basic_workflow(toy_models):
    m = toy_models

    @compose("toy_basic")
    def wf_fn(wf, steps=6):
        seed = wf.add_input("seed", int)
        prompt = wf.add_input("prompt", str)
        lat = m["latgen"](seed)
        emb = m["enc"](prompt)
        for _ in range(steps):
            noise = m["backbone"](lat, emb, cn=None)
            lat = m["denoise"](noise, lat)
        img = m["vae"](lat)
        wf.add_output(img, name="img")

    return wf_fn
