"""The port's approximate cache (``repro_torch.diffusion.cache``) against
the JAX package's.

* ``prompt_signature``, ``jaccard`` and ``ApproxCache`` under the same
  seeded operation sequences (inserts, lookups, ``would_hit``) give the
  same results, counters, LRU order and per-entry contents: equality;
* the JAX package's executable-plane case
  (``tests/test_diffusion_exec.py::test_approx_cache_executable_plane``)
  served by the port at the toy size from the same weights and the same
  cached latent: the image within 1e-4 relative (L2 norm of the difference
  over the norm of the JAX image; the served fp32 bound of
  ``tests/test_torch_serving.py``), a cache hit counted, and the cached
  tensor unchanged after the run (the segment stacks a copy; under
  ``REPRO_DONATE`` too)."""

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.diffusion as jdiff
from repro.core.passes import ApproximateCachingPass as JCachingPass
from repro.core.passes import InlineTrivialPass as JInline
from repro.core.passes import JitCompilePass as JJit
from repro.diffusion import cache as jcache
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
from repro_torch.core.passes import (
    ApproximateCachingPass,
    InlineTrivialPass,
    JitCompilePass,
)
from repro_torch.diffusion import cache as tcache
from repro_torch.diffusion.sampler import set_donate_buffers
from repro_torch.weights import from_numpy

PROMPTS = ["a watercolor fox in a snowy forest", "A Watercolor FOX at dawn",
           "cyberpunk street market at night, neon rain", "a fox", "",
           "macro photo of a dew drop on a fern", "the fox and the forest",
           "art nouveau poster of a hummingbird", "low-poly desert caravan"]


def test_signature_and_jaccard_equal_reference():
    for a in PROMPTS:
        assert tcache.prompt_signature(a) == jcache.prompt_signature(a)
        for b in PROMPTS:
            sa, sb = tcache.prompt_signature(a), tcache.prompt_signature(b)
            assert tcache.jaccard(sa, sb) == jcache.jaccard(sa, sb)


def _state(cache):
    return ([(sorted(sig), list(entry.items()))
             for sig, entry in cache._entries.items()],
            len(cache), cache.hits, cache.misses, cache.evictions)


@pytest.mark.parametrize("threshold,capacity,per_entry,seed", [
    (0.5, 1024, 8, 0),      # the defaults
    (0.3, 3, 2, 1),         # LRU and per-entry eviction under pressure
    (0.0, 4, 3, 2),         # any overlap hits
    (1.0, 2, 1, 3),         # only the exact signature hits
])
def test_cache_operations_equal_reference(threshold, capacity, per_entry, seed):
    caches = [mod.ApproxCache(threshold, capacity, per_entry)
              for mod in (jcache, tcache)]
    rng = np.random.default_rng(seed)
    for i in range(300):
        op = int(rng.integers(3))
        prompt = PROMPTS[int(rng.integers(len(PROMPTS)))]
        step = int(rng.integers(6))
        if op == 0:
            results = [c.insert(prompt, step, ("latent", i)) for c in caches]
        elif op == 1:
            results = [c.lookup(prompt, step) for c in caches]
        else:
            results = [(c.would_hit(prompt), c.best_match(prompt))
                       for c in caches]
        assert results[1] == results[0], (i, op, prompt, step)
        assert _state(caches[1]) == _state(caches[0])
    assert caches[1].hits and caches[1].misses


# ---------------------------------------------------------------------------
# served: the approximate-caching pass on the executable plane
# ---------------------------------------------------------------------------

def _cached_latent():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(9), (1, 16, 16, 4)))


def _serve_jax(lat):
    cache = jdiff.ApproxCache(similarity_threshold=0.0)
    cache.insert("a warm prompt", 2, jax.numpy.asarray(lat))
    passes = [JCachingPass(cache, "backbone:sd3", skip_fraction=0.5),
              JInline(), JJit()]
    system = jcore.ServingSystem(n_executors=2, backend=jcore.LocalBackend(),
                                 extra_passes=passes)
    system.register(jdiff.make_basic_workflow("sd3"))
    req = system.submit("sd3:basic",
                        inputs={"seed": 0, "prompt": "a warm prompt"}, steps=4)
    system.run()
    assert req.status == "done" and cache.hits >= 1
    return np.asarray(system.coordinator.engine.value_of(
        req.ref_key(req.graph.outputs["image"])))


def _port_modelset():
    jms = jdiff.ModelSet(jdiff.SD3)
    ms = tdiff.ModelSet(tdiff.SD3)
    for name in ("text_enc", "backbone", "vae_dec"):
        params = getattr(jms, name).load()["params"]
        getattr(ms, name).weights = from_numpy(jax.tree.map(np.asarray, params))
    return ms


@pytest.mark.parametrize("donate", [False, True])
def test_served_cache_hit_matches_reference(donate):
    lat = _cached_latent()
    want = _serve_jax(lat)
    held = torch.from_numpy(lat.copy())
    cache = tdiff.ApproxCache(similarity_threshold=0.0)
    cache.insert("a warm prompt", 2, held)
    passes = [ApproximateCachingPass(cache, "backbone:sd3", skip_fraction=0.5),
              InlineTrivialPass(), JitCompilePass()]
    prev = set_donate_buffers(donate)
    try:
        system = tcore.ServingSystem(
            n_executors=2, backend=tcore.LocalBackend(device="cpu"),
            extra_passes=passes)
        system.register(tdiff.make_basic_workflow("sd3", _port_modelset()))
        req = system.submit("sd3:basic",
                            inputs={"seed": 0, "prompt": "a warm prompt"},
                            steps=4)
        system.run()
    finally:
        set_donate_buffers(prev)
    assert req.status == "done"
    assert cache.hits >= 1 and cache.misses == 0
    # the denoise chain kept 2 of its 4 steps, fused into one segment
    segs = [d.segment_steps for d in system.coordinator.dispatch_log
            if d.model_id.startswith("segment:")]
    assert sum(segs) == 2, segs
    got = system.coordinator.engine.value_of(
        req.ref_key(req.graph.outputs["image"]))
    err = float(np.linalg.norm(got.numpy().astype(np.float64) - want)
                / np.linalg.norm(want.astype(np.float64)))
    assert err < 1e-4
    # the cache still holds the very tensor it was given, unchanged
    assert cache.lookup("a warm prompt", 2) is held
    assert torch.equal(held, torch.from_numpy(lat.copy()))
