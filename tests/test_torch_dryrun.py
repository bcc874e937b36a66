"""The port's dry run (``repro_torch.launch.dryrun`` and
``dryrun_diffusion``) against the JAX package's, on a (2, 4) mesh.

The JAX side lowers and compiles each step for 8 forced host devices in
one subprocess (as ``tests/test_distributed.py`` runs it) and reads its
costs from the HLO; the port traces the same step on the ``meta`` device
as rank 0 of a fake process group of 8.  Cases: ``ARCHS['qwen3-1.7b']
.reduced()`` at train_4k, prefill_32k and decode_32k, and one CFG step of
a narrow ``DiTConfig`` added to both packages' ``REAL`` at run time;
train_4k and decode_32k again with the weights split over ``data`` too
(``needs_fsdp`` made true on both sides).

* per-partition FLOPs within 5 % of the reference's ``hlo_flops``;
* ``bytes_per_device["argument"]`` equal to the reference's;
* total collective bytes within 2x of the reference's (each kind is
  printed beside the reference's).

The DiT is held against the reference with its flash attention off: on
the CPU the JAX package's flash attention is a Pallas kernel in interpret
mode, whose loop XLA cannot partition, so it is replicated on every
device and its operands all-gathered inside the loop; its numbers are
printed beside the others.  Last, the CLI end to end on the production
mesh.  The other architectures, shapes and families are held in
``test_torch_dryrun_*.py`` through :func:`cases_reference` and
:func:`check_case`."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOPS_REL = 0.05
COLL_RATIO = 2.0
SHAPES = ["prefill_32k", "train_4k", "decode_32k"]
# the same steps with the weights split over "data" too (ZeRO-3 style),
# as the rules split the large configs'
FSDP_SHAPES = ["train_4k", "decode_32k"]
NARROW = dict(d_model=256, n_layers=2, n_heads=4, d_ff=1024, text_dim=512,
              latent_size=32, latent_channels=16, patch=2, text_tokens=64)

_REFERENCE = """
import os, json
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS
from repro.diffusion.config import DiTConfig
from repro.launch import dryrun as dr, dryrun_diffusion as dd
from repro.launch import sharding as shd
import repro.nn.layers as layers
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ('data', 'model'))
keys = ('hlo_flops', 'hlo_bytes', 'collectives', 'bytes_per_device')
out = {}
for shape in SHAPES:
    lowered, meta = dr.build_lowered(ARCHS['qwen3-1.7b'].reduced(), shape,
                                     mesh=mesh)
    r = dr.analyze(lowered, meta)
    out[shape] = {k: r[k] for k in keys}
dd.REAL['narrow'] = DiTConfig(dtype=jnp.bfloat16, **NARROW)
for flash in (True, False):
    layers.set_flash_attention(flash)
    lowered, meta = dd.build('narrow', 4, mesh)
    r = dr.analyze(lowered, meta)
    out['dit' if not flash else 'dit_interpret'] = {k: r[k] for k in keys}
shd.needs_fsdp = lambda cfg, kind: True
for shape in FSDP_SHAPES:
    lowered, meta = dr.build_lowered(ARCHS['qwen3-1.7b'].reduced(), shape,
                                     mesh=mesh)
    assert meta['fsdp']
    r = dr.analyze(lowered, meta)
    out['fsdp ' + shape] = {k: r[k] for k in keys}
print(json.dumps(out, default=float))
"""


def spawn_reference(code):
    """Start ``code`` (the JAX package's side, which prints one JSON object
    last) in a subprocess; yields a function that waits for it and returns
    the object, and kills the subprocess after (a generator for a
    module-scoped fixture)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    cache = {}

    def get():
        if not cache:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            cache.update(json.loads(out.strip().splitlines()[-1]))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def reference():
    """The JAX package's numbers, from a subprocess started before the
    port's first trace, so that the two overlap."""
    yield from spawn_reference(
        f"SHAPES = {SHAPES!r}\nNARROW = {NARROW!r}\n"
        f"FSDP_SHAPES = {FSDP_SHAPES!r}\n" + textwrap.dedent(_REFERENCE))


# the JAX package's side of the files that hold every architecture and
# diffusion family against it (test_torch_dryrun_*.py): CASES holds
# (arch or family, shape, variant) triples; flash attention is off (see
# the module's docstring), and the variant "adafactor" makes
# ``param_count`` read 2e11, which puts a train step on Adafactor (and 32
# microbatches)
_CASES_REFERENCE = """
import os, json
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS
from repro.launch import dryrun as dr, dryrun_diffusion as dd
from repro.models.base import ArchConfig
import repro.nn.layers as layers
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ('data', 'model'))
layers.set_flash_attention(False)
keys = ('hlo_flops', 'hlo_bytes', 'collectives', 'bytes_per_device')
count = ArchConfig.param_count
out = {}
for arch, shape, variant in CASES:
    ArchConfig.param_count = ((lambda self: 2e11) if variant == 'adafactor'
                              else count)
    if arch in dd.REAL:
        lowered, meta = dd.build(arch, 4, mesh)
    else:
        lowered, meta = dr.build_lowered(ARCHS[arch].reduced(), shape,
                                         mesh=mesh)
    r = dr.analyze(lowered, meta)
    out[' '.join((arch, shape, variant)).strip()] = {
        k: r[k] for k in keys}
print(json.dumps(out, default=float))
"""


def cases_reference(cases):
    """A module-scoped fixture's generator of the JAX package's numbers for
    ``cases`` (see ``_CASES_REFERENCE``), keyed by ``case_key``."""
    return spawn_reference(f"CASES = {list(cases)!r}\n"
                           + textwrap.dedent(_CASES_REFERENCE))


def case_key(case) -> str:
    return " ".join(case).strip()


def check_case(case, mesh, reference, monkeypatch):
    """Trace ``case`` on the port's side and hold it against the
    reference's under :func:`_check`'s gates; returns the port's report."""
    from repro_torch.configs import ARCHS
    from repro_torch.diffusion.config import REAL
    from repro_torch.launch import dryrun, dryrun_diffusion
    from repro_torch.models.base import ArchConfig

    arch, shape, variant = case
    if variant == "adafactor":
        monkeypatch.setattr(ArchConfig, "param_count", lambda self: 2e11)
    if arch in REAL:
        run, meta = dryrun_diffusion.build(arch, 4, mesh)
    else:
        run, meta = dryrun.build_step(ARCHS[arch].reduced(), shape,
                                      mesh=mesh)
    got = dryrun.analyze(run, meta)
    assert got["per_partition"] and got["mesh"] == "2x4"
    name = arch if arch in REAL else f"{arch}-reduced"
    _check(f"{name} x {shape} {variant}".strip(), got,
           reference()[case_key(case)])
    return got


@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch.mesh import release, small_mesh

    yield small_mesh(2, 4)
    release()


def _check(case, got, want):
    coll_got = got["collectives"]["total"]
    coll_want = want["collectives"]["total"]
    print(f"{case}: flops {got['flops']:.6e} (reference "
          f"{want['hlo_flops']:.6e}), bytes {got['bytes']:.6e} (reference "
          f"{want['hlo_bytes']:.6e}), argument bytes "
          f"{got['bytes_per_device']['argument']} (reference "
          f"{want['bytes_per_device']['argument']})")
    kinds = sorted(set(got["collectives"]) | set(want["collectives"]))
    for k in kinds:
        print(f"  {k:>18}: {got['collectives'].get(k, 0.0):.6e} "
              f"(reference {want['collectives'].get(k, 0.0):.6e})")
    assert abs(got["flops"] - want["hlo_flops"]) <= FLOPS_REL * want[
        "hlo_flops"], case
    assert (got["bytes_per_device"]["argument"]
            == want["bytes_per_device"]["argument"]), case
    assert coll_want / COLL_RATIO <= coll_got <= coll_want * COLL_RATIO, case


@pytest.mark.parametrize("shape,fsdp", [(s, False) for s in SHAPES]
                         + [(s, True) for s in FSDP_SHAPES])
def test_llm_step_costs_match_the_reference(shape, fsdp, reference, mesh,
                                            monkeypatch):
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun, sharding

    if fsdp:
        monkeypatch.setattr(sharding, "needs_fsdp", lambda cfg, kind: True)
    run, meta = dryrun.build_step(ARCHS["qwen3-1.7b"].reduced(), shape,
                                  mesh=mesh)
    got = dryrun.analyze(run, meta)
    assert got["per_partition"] and got["kind"] == meta["kind"]
    assert got["mesh"] == "2x4" and got["fsdp"] == fsdp
    key = f"fsdp {shape}" if fsdp else shape
    _check(f"qwen3-1.7b-reduced x {key}", got, reference()[key])


def test_diffusion_step_costs_match_the_reference(reference, mesh,
                                                  monkeypatch):
    from repro_torch.diffusion.config import REAL, DiTConfig
    from repro_torch.launch import dryrun, dryrun_diffusion

    monkeypatch.setitem(REAL, "narrow",
                        DiTConfig(dtype=torch.bfloat16, **NARROW))
    run, meta = dryrun_diffusion.build("narrow", 4, mesh)
    got = dryrun.analyze(run, meta)
    ref = reference()
    interp = ref["dit_interpret"]
    print(f"reference with its interpreted flash kernel: flops "
          f"{interp['hlo_flops']:.6e}, collectives "
          f"{interp['collectives']['total']:.6e}")
    _check("narrow DiT x denoise_b4_cfg", got, ref["dit"])


def test_dryrun_cli_single_pair():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK   whisper-tiny x decode_32k x 16x16" in out.stdout
    skip = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "long_500k"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert skip.returncode == 0 and skip.stdout.startswith(
        "SKIP whisper-tiny x long_500k")
