"""The toy ``sd3:basic`` request served end to end through the port's
``ServingSystem`` on the CPU, against the same request through the JAX
package's, on converted weights and the JAX package's latents.
Tolerance: 1e-4 relative (L2 norm of the image difference over the norm
of the JAX image): five denoising steps of f32 forwards whose sums run in
another order in each framework.

Also: fused ``DenoiseSegment`` execution equals the unfused per-step
chain bit for bit inside the port (mirrors ``tests/test_segments.py``),
and the backend refuses to run on a card that is not there."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.diffusion as jdiff
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
from repro_torch.core.passes import (
    AsyncLoRAPass,
    InlineTrivialPass,
    JitCompilePass,
)
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.weights import from_numpy

REQUESTS = [{"seed": 0, "prompt": "a fox"},
            {"seed": 1, "prompt": "two foxes in the snow"}]
UNFUSED = [InlineTrivialPass(), AsyncLoRAPass(), JitCompilePass()]


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _images(system, reqs):
    assert all(r.status == "done" for r in reqs)
    return [system.coordinator.engine.value_of(
        r.ref_key(r.graph.outputs["image"])) for r in reqs]


def _serve_jax(family_name, steps, jms=None):
    system = jcore.ServingSystem(n_executors=2, backend=jcore.LocalBackend())
    system.register(jdiff.make_basic_workflow(family_name, jms))
    reqs = [system.submit(f"{family_name}:basic", inputs=dict(inp),
                          arrival=0.0, steps=steps) for inp in REQUESTS]
    system.run()
    return [np.asarray(x) for x in _images(system, reqs)]


def _port_modelset_from_jax(family_name, jms=None, family=None):
    """A port ModelSet carrying the JAX package's weights and latents
    (those of ``jms`` and the port's ``family`` where given)."""
    jms = jms or jdiff.ModelSet(jdiff.FAMILIES[family_name])
    ms = tdiff.ModelSet(family or tdiff.FAMILIES[family_name])
    for name in ("text_enc", "backbone", "vae_dec"):
        params = getattr(jms, name).load()["params"]
        getattr(ms, name).weights = from_numpy(jax.tree.map(np.asarray, params))
    cfg = ms.family.toy
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    ms.latents.source = lambda seed: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))
    return ms


def _serve_port(ms, steps, fused=True, segment_chunk=None):
    system = tcore.ServingSystem(
        n_executors=2, backend=tcore.LocalBackend(device="cpu"))
    if not fused:
        system.registry.compiler = tcore.GraphCompiler(list(UNFUSED))
    if segment_chunk is not None:
        system.coordinator.scheduler = tcore.Scheduler(
            system.profiles, use_declared_max_batch=True,
            segment_chunk=segment_chunk)
    wf = tdiff.make_basic_workflow(ms.family.name, ms=ms)
    system.register(wf)
    reqs = [system.submit(wf.name, inputs=dict(inp), arrival=0.0, steps=steps)
            for inp in REQUESTS]
    system.run()
    return _images(system, reqs), system


@pytest.mark.parametrize("family_name", ["sd3", "flux-schnell"])
def test_served_image_matches_jax(family_name):
    want = _serve_jax(family_name, steps=5)
    got, system = _serve_port(_port_modelset_from_jax(family_name), steps=5)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert g.device.type == "cpu"
        assert rel_err(g.numpy(), w) < 1e-4
    # the denoise chain ran as fused segments
    assert any(m.startswith("segment:") for m, _ in
               system.coordinator.backend.forward_log)


def test_head_dim_128_flux_image_matches_jax(monkeypatch):
    """flux-schnell at a narrow DiT with Flux's published head dim (2 heads
    of 128, d 256, 2 layers), 4 steps: the served image through both
    packages on the same weights within 1e-4 relative.  The JAX side runs
    its Pallas kernel in interpret mode at head dim 128; the port's joint
    attention takes the flash route (its plain version on the CPU) at
    head dim 128."""
    narrow = dict(d_model=256, n_layers=2, n_heads=2, d_ff=1024)
    jms = jdiff.ModelSet(dataclasses.replace(
        jdiff.FLUX_SCHNELL,
        toy=dataclasses.replace(jdiff.FLUX_SCHNELL.toy, **narrow)))
    family = dataclasses.replace(
        tdiff.FLUX_SCHNELL,
        toy=dataclasses.replace(tdiff.FLUX_SCHNELL.toy, **narrow))
    assert family.toy.head_dim == 128
    from repro_torch.kernels.flash_attention import ops as fa_ops
    head_dims = []
    real_mha = fa_ops.mha

    def spy(q, k, v, **kw):
        head_dims.append(q.shape[-1])
        return real_mha(q, k, v, **kw)

    monkeypatch.setattr(fa_ops, "mha", spy)
    want = _serve_jax("flux-schnell", steps=4, jms=jms)
    got, _ = _serve_port(
        _port_modelset_from_jax("flux-schnell", jms=jms, family=family),
        steps=4)
    assert 128 in head_dims
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert rel_err(g.numpy(), w) < 1e-4


@pytest.mark.parametrize("family_name", ["sd3", "flux-schnell"])
def test_segment_parity_bitexact(family_name):
    """steps=5 puts non-dyadic dt values on the schedule."""
    ms = tdiff.ModelSet(tdiff.FAMILIES[family_name])
    unfused, _ = _serve_port(ms, steps=5, fused=False)
    full, _ = _serve_port(ms, steps=5)
    chunk4, sys_c4 = _serve_port(ms, steps=5, segment_chunk=4)
    for got in (full, chunk4):
        for g, w in zip(got, unfused):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    chunks = {}
    for d in sys_c4.coordinator.dispatch_log:
        if d.model_id.startswith("segment:"):
            for rn in d.nodes:
                chunks.setdefault(rn.uid, []).append(d.segment_steps)
    assert chunks and all(c == [4, 1] for c in chunks.values()), chunks


def test_cpu_run_launches_no_kernel_and_is_seeded():
    before = flash_attention.launches
    a, _ = _serve_port(tdiff.ModelSet(tdiff.SD3), steps=2)
    b, _ = _serve_port(tdiff.ModelSet(tdiff.SD3), steps=2)
    assert flash_attention.launches == before
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert tuple(x.shape) == (1, 128, 128, 3)
        assert bool(torch.isfinite(x).all()) and float(x.abs().max()) <= 1.0
    assert not torch.equal(a[0], a[1])      # different seeds and prompts


def test_local_backend_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.LocalBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.LocalBackend(device="cuda:0")
    assert tcore.LocalBackend(device="cpu").device == torch.device("cpu")


def test_overlap_is_refused_until_ported(monkeypatch):
    """Overlap is ported: ``VAEDecode`` is overlappable, and a Coordinator
    asked for overlap (by argument or by ``REPRO_OVERLAP``) is built with
    it on instead of raising."""
    assert tdiff.ops.VAEDecode(tdiff.SD3).overlappable
    system = tcore.ServingSystem(n_executors=1, overlap=True,
                                 backend=tcore.LocalBackend(device="cpu"))
    assert system.coordinator.overlap
    from repro_torch.core import runtime
    monkeypatch.setattr(runtime, "_overlap_enabled", True)
    system = tcore.ServingSystem(n_executors=1,
                                 backend=tcore.LocalBackend(device="cpu"))
    assert system.coordinator.overlap
