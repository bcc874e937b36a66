"""The raw-speed plane in the port: donated latent carries
(``REPRO_DONATE``) and denoise/decode overlap (``REPRO_OVERLAP``), the
cases of the JAX package's ``tests/test_rawspeed.py``.

* donation: the fused segment updates the carry it stacked in place
  (``denoise_step_``; the carry keeps its ``data_ptr`` across the steps),
  never a tensor the datastore or a caller holds (the stack always
  copies), and its output equals the out-of-place run's bit for bit;
* overlap: ``VAEDecode`` alone is ``overlappable``; on the simulation
  plane the makespan, ``n_overlap_dispatches`` and
  ``overlap_hidden_seconds`` equal the JAX package's with overlap on and
  off (equality: the same virtual timeline), with at most one overlap per
  segment window; on the executable plane the images with overlap on
  equal those with it off bit for bit."""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.diffusion as jdiff
import repro_torch.core as tcore
import repro_torch.diffusion as tdiff
from repro_torch.core.runtime import overlap_enabled, set_overlap
from repro_torch.diffusion import ops, sampler
from repro_torch.diffusion.ops import DenoiseSegment, DiffusionBackbone, VAEDecode
from repro_torch.diffusion.sampler import donate_buffers_enabled, set_donate_buffers


# --------------------------------------------------------------------------
# donation
# --------------------------------------------------------------------------

def _segment(steps=3):
    return DenoiseSegment(DiffusionBackbone(tdiff.SD3), [], steps)


def _seg_kwargs(seg, b=2):
    cfg = seg.family.toy
    r = np.random.default_rng(3)
    lat = torch.from_numpy(r.standard_normal(
        (b, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    ).astype(np.float32))
    emb = torch.from_numpy(r.standard_normal(
        (b, cfg.text_tokens, cfg.text_dim)).astype(np.float32))
    # steps=3 puts non-dyadic dt values on the schedule
    grid = np.linspace(1.0, 0.0, seg.n_steps + 1)
    return {"latents": lat, "prompt_embeds": emb,
            "t_mid": tuple((grid[:-1] + grid[1:]) / 2),
            "t_cur": tuple(grid[:-1]), "t_next": tuple(grid[1:]),
            "guidance": 4.5}


def _load(seg, donate):
    prev = set_donate_buffers(donate)
    try:
        return seg.load("cpu")
    finally:
        set_donate_buffers(prev)


def test_donate_flag_roundtrip():
    prev = set_donate_buffers(True)
    try:
        assert donate_buffers_enabled()
        assert set_donate_buffers(False) is True
        assert not donate_buffers_enabled()
    finally:
        set_donate_buffers(prev)


@pytest.mark.parametrize("donate", [False, True])
def test_donated_carry_is_updated_in_place(monkeypatch, donate):
    """Under the flag every step writes the segment's own carry: one
    ``data_ptr`` through the whole chunk, and the chunk returns that very
    tensor; without it each step allocates."""
    seg = _segment()
    comps = _load(seg, donate)
    assert comps["donate"] is donate
    ptrs = []

    def traced(fn):
        def step(lat, v, tc, tn):
            out = fn(lat, v, tc, tn)
            ptrs.append((lat.data_ptr(), out.data_ptr()))
            return out
        return step

    monkeypatch.setattr(ops, "denoise_step", traced(sampler.denoise_step))
    monkeypatch.setattr(ops, "denoise_step_", traced(sampler.denoise_step_))
    kw = _seg_kwargs(seg)
    lat, emb, cond, sizes = seg._stack(torch.device("cpu"), [kw])
    out = seg._run(comps, [kw], sizes, seg.n_steps, lat, emb, cond)
    assert len(ptrs) == seg.n_steps
    if donate:
        assert out is lat
        assert {p for pair in ptrs for p in pair} == {lat.data_ptr()}
    else:
        assert all(a != b for a, b in ptrs)


@pytest.mark.parametrize("n_requests", [1, 2])
def test_stack_copies_even_one_request(n_requests):
    """The guard the in-place carry rests on: ``_stack``'s ``torch.cat``
    copies, even a single request's latents already on the device."""
    seg = _segment()
    kws = [_seg_kwargs(seg, b=1) for _ in range(n_requests)]
    lat, _, _, sizes = seg._stack(torch.device("cpu"), kws)
    assert sizes == [1] * n_requests
    assert all(lat.data_ptr() != kw["latents"].data_ptr() for kw in kws)


def test_datastore_value_preserved_and_parity_bitexact():
    """``execute`` with donation on leaves the caller's (the engine's)
    tensor as it was, and computes the out-of-place run's bits."""
    seg = _segment()
    kw = _seg_kwargs(seg)
    held = kw["latents"]
    before = held.clone()
    got = seg.execute(_load(seg, True), **dict(kw))["latents"]
    assert torch.equal(held, before)
    want = seg.execute(_load(seg, False), **dict(kw))["latents"]
    assert got.shape == held.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _serve_basic(donate, overlap=False, n=3, steps=5, chunk=2):
    prev = set_donate_buffers(donate)
    try:
        s = tcore.ServingSystem(n_executors=1, overlap=overlap,
                                backend=tcore.LocalBackend(device="cpu"))
        s.coordinator.scheduler = tcore.Scheduler(
            s.profiles, use_declared_max_batch=True, segment_chunk=chunk)
        wf = tdiff.make_basic_workflow("sd3")
        s.register(wf)
        reqs = [s.submit(wf.name, inputs={"seed": i, "prompt": f"p{i}"},
                         arrival=0.0, steps=steps) for i in range(n)]
        s.run()
    finally:
        set_donate_buffers(prev)
    assert all(r.status == "done" for r in reqs)
    return s, [s.coordinator.engine.value_of(
        r.ref_key(r.graph.outputs["image"])) for r in reqs]


def test_served_donation_parity_bitexact():
    """Stacked batches over chunks of 2 of 5 steps: every chunk resumes
    from the previous chunk's carry; the images equal the run without
    donation bit for bit, and the audit finds nothing."""
    from repro_torch.sim import check_invariants

    on, got = _serve_basic(True)
    _, want = _serve_basic(False)
    chunks = [d.segment_steps for d in on.coordinator.dispatch_log
              if d.model_id.startswith("segment:")]
    assert max(chunks) == 2 and len(chunks) >= 3, chunks
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert check_invariants(on.coordinator) == []


# --------------------------------------------------------------------------
# overlap
# --------------------------------------------------------------------------

def test_overlap_flag_roundtrip():
    prev = set_overlap(True)
    try:
        assert overlap_enabled()
        assert set_overlap(False) is True
        assert not overlap_enabled()
    finally:
        set_overlap(prev)


def test_overlappable_is_declared_on_vae_only():
    assert VAEDecode(tdiff.SD3).overlappable
    ms = tdiff.ModelSet(tdiff.SD3)
    others = [ms.latents, ms.text_enc, ms.backbone, ms.cn1, ms.vae_enc,
              ms.denoise, ms.combine, _segment(), tdiff.LoRAAdapter(tdiff.SD3)]
    assert not any(getattr(m, "overlappable", False) for m in others)


def _sim_arm(core, diff, overlap, n=6, steps=6):
    s = core.ServingSystem(n_executors=1, overlap=overlap)
    s.coordinator.scheduler = core.Scheduler(
        s.profiles, use_declared_max_batch=True, max_batch_cap=1,
        segment_chunk=steps)
    wf = diff.make_basic_workflow("sd3")
    s.register(wf)
    reqs = [s.submit(wf.name, inputs={"seed": i, "prompt": f"p{i}"},
                     arrival=0.0, steps=steps) for i in range(n)]
    s.run()
    assert all(r.status == "done" for r in reqs)
    return s.coordinator


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("n,steps", [(6, 6), (4, 3), (9, 5)])
def test_sim_overlap_equals_reference(overlap, n, steps):
    got = _sim_arm(tcore, tdiff, overlap, n, steps)
    want = _sim_arm(jcore, jdiff, overlap, n, steps)
    assert (got.now, got.n_overlap_dispatches, got.overlap_hidden_seconds) == (
        want.now, want.n_overlap_dispatches, want.overlap_hidden_seconds)
    assert [(b.model_id, b.overlap_window, b.batch_size)
            for b in got.dispatch_log] == [
        (b.model_id, b.overlap_window, b.batch_size) for b in want.dispatch_log]
    assert len(got.finished) == n
    if not overlap:
        assert got.n_overlap_dispatches == 0


def test_overlap_shrinks_sim_makespan_one_slot_per_window():
    off = _sim_arm(tcore, tdiff, overlap=False)
    on = _sim_arm(tcore, tdiff, overlap=True)
    assert on.n_overlap_dispatches > 0 and on.overlap_hidden_seconds > 0
    assert on.now < off.now
    n_segments = sum(1 for b in on.dispatch_log
                     if b.model_id.startswith("segment:"))
    assert 0 < on.n_overlap_dispatches <= n_segments
    windowed = [b for b in on.dispatch_log if b.overlap_window > 0]
    assert len(windowed) == on.n_overlap_dispatches
    assert all(b.model_id.startswith("vae:") and b.batch_size == 1
               for b in windowed)


def test_overlap_executable_plane_bitexact():
    """Overlap reorders the coordinator's timeline, never the arithmetic:
    the served images equal the overlap-off run's bit for bit, and a
    decode really rode a segment window."""
    def arm(overlap):
        prev = set_donate_buffers(False)
        try:
            s = tcore.ServingSystem(n_executors=1, overlap=overlap,
                                    backend=tcore.LocalBackend(device="cpu"))
            s.coordinator.scheduler = tcore.Scheduler(
                s.profiles, use_declared_max_batch=True, max_batch_cap=1,
                segment_chunk=4)
            wf = tdiff.make_basic_workflow("sd3")
            s.register(wf)
            reqs = [s.submit(wf.name, inputs={"seed": i, "prompt": f"p{i}"},
                             arrival=0.0, steps=4) for i in range(4)]
            s.run()
        finally:
            set_donate_buffers(prev)
        assert all(r.status == "done" for r in reqs)
        return s, [s.coordinator.engine.value_of(
            r.ref_key(r.graph.outputs["image"])) for r in reqs]

    _, want = arm(False)
    on, got = arm(True)
    assert on.coordinator.n_overlap_dispatches > 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
