"""Table 2's two-family settings replayed through the port's serving
launcher and through the JAX package's, on the CPU at toy width.

S5 (sd3 and sd3.5-large) and S6 (flux-schnell and flux-dev) put two
families on one executor.  At toy width every family shares one DiT
config, so S6 also covers the workflows of S3 and S4.  The port runs
``repro_torch.launch.serve.serve()`` with ``--plane local --device cpu
--executors 1 --no-admission`` and one ``ModelSet`` a family, each carrying
the JAX package's weights and latents.  The JAX package is driven as its
launcher (``repro/launch/serve.py``) drives it: ``ServingSystem`` on a
``LocalBackend``, ``table2_setting``, ``generate_trace(seed=0)``, the
first 8 requests at 3 steps.

Both runs must finish the same requests with the same workflows and
dispatch the same fused segments.  Each image must lie within 1e-4
relative (L2 norm of the difference over the norm of the JAX image) of
the JAX package's.  Batches form on measured seconds, which differ
between the packages, so the image bound has to hold whatever batches
formed: at f32 a different row count moves the bits far less than
1e-4."""

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.diffusion as jdiff
import repro_torch.diffusion as tdiff
from repro.sim import generate_trace
from repro_torch.diffusion.workflows import TABLE2_FAMILIES
from repro_torch.launch.serve import parse_args, serve
from repro_torch.sim import check_invariants
from repro_torch.weights import from_numpy

REL_TOL = 1e-4
ARGV = ["--plane", "local", "--device", "cpu", "--executors", "1",
        "--no-admission"]
MODELS = ("text_enc", "backbone", "vae_dec", "vae_enc", "cn1", "cn2")


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _images(system):
    c = system.coordinator
    return {r.rid: c.engine.value_of(r.ref_key(r.graph.outputs["image"]))
            for r in c.finished}


def _segments(system):
    return {d.model_id for d in system.coordinator.dispatch_log
            if d.model_id.startswith("segment:")}


def _serve_jax(setting):
    """The first 8 requests of ``setting``'s trace, as the JAX package's
    launcher serves them on its local plane without admission."""
    wfs = jdiff.table2_setting(setting)
    system = jcore.ServingSystem(n_executors=1, admission_enabled=False,
                                 backend=jcore.LocalBackend())
    for wf in wfs.values():
        system.register(wf)
    solo = {n: system.solo_latency(n) for n in wfs}
    trace = generate_trace(list(wfs), rate=1.0, duration=120.0, cv=2.0,
                           seed=0)
    for t in trace[:8]:
        system.submit(t.workflow, inputs=t.inputs, arrival=t.arrival,
                      slo_seconds=2.0 * solo[t.workflow], steps=3)
    system.run()
    return system


def _port_modelset(name):
    """The port's ``ModelSet`` of family ``name`` carrying the JAX
    package's weights (drawn from the same model ids) and latents."""
    jms = jdiff.ModelSet(jdiff.FAMILIES[name])
    ms = tdiff.ModelSet(tdiff.FAMILIES[name])
    for model in MODELS:
        params = getattr(jms, model).load()["params"]
        getattr(ms, model).weights = from_numpy(
            jax.tree.map(np.asarray, params))
    cfg = ms.family.toy
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    ms.latents.source = lambda seed: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))
    return ms


@pytest.mark.parametrize("setting", ["s5", "s6"])
def test_two_family_trace_matches_jax(setting):
    families = TABLE2_FAMILIES[setting]
    want = _serve_jax(setting)
    got = serve(parse_args(ARGV + ["--setting", setting]),
                model_sets={f: _port_modelset(f) for f in families})
    jc, tc = want.coordinator, got.coordinator
    assert len(tc.finished) == len(jc.finished) == 8 and not tc.rejected
    assert check_invariants(tc) == []
    assert (sorted((r.rid, r.workflow_name) for r in tc.finished)
            == sorted((r.rid, r.workflow_name) for r in jc.finished))
    # both families ran fused segments on the one executor, and every
    # segment id of the reference's run was dispatched
    assert _segments(got) == _segments(want)
    assert {m.split("+")[0].rsplit(":", 1)[1] for m in _segments(got)} == set(
        families)
    want_images = _images(want)
    for rid, img in _images(got).items():
        ref = np.asarray(want_images[rid])
        assert img.dtype == torch.float32 and tuple(img.shape) == ref.shape
        assert rel_err(img.numpy(), ref) < REL_TOL, rid
