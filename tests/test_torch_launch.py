"""The port's serving launcher (``python -m repro_torch.launch.serve``).

* ``--plane sim`` prints the same summary lines as the JAX package's
  launcher with the same arguments (both ``main``s' standard output,
  compared as text: the same trace through the same control plane);
* ``--plane local --device cpu`` serves the trace's first 8 requests at
  the toy size to the end, with a clean ``check_invariants``;
* ``--device cuda`` with no card raises; the simulation plane builds no
  backend."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

import repro.launch.serve as jserve
import repro_torch.launch.serve as tserve
from repro_torch.sim import check_invariants


def _stdout(main, argv, monkeypatch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        if main is jserve.main:
            # the JAX package's main reads sys.argv
            monkeypatch.setattr(sys, "argv", ["serve", *argv])
            main()
        else:
            main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["--setting", "s1", "--duration", "60"],
    ["--setting", "s6", "--duration", "60"],
    ["--setting", "s1", "--duration", "40", "--executors", "3",
     "--rate", "2.0", "--cv", "1.0", "--slo-scale", "1.5"],
    ["--setting", "s5", "--duration", "40", "--no-admission"],
])
def test_sim_plane_prints_the_reference_numbers(argv, monkeypatch):
    argv = ["--plane", "sim", *argv]
    want = _stdout(jserve.main, argv, monkeypatch)
    got = _stdout(tserve.main, argv, monkeypatch)
    assert got == want
    assert got.startswith("requests: ") and len(got.splitlines()) == 4


def test_sim_plane_builds_no_backend():
    system = tserve.serve(tserve.parse_args(["--duration", "20"]))
    assert system.coordinator.backend is None
    assert len(system.coordinator.finished) > 0


def test_local_plane_on_the_cpu_serves_eight_requests():
    args = tserve.parse_args(["--plane", "local", "--device", "cpu",
                              "--executors", "2"])
    assert (args.setting, args.rate, args.duration, args.cv) == (
        "s1", 1.0, 120.0, 2.0)
    system = tserve.serve(args)
    c = system.coordinator
    assert c.backend.device == torch.device("cpu")
    assert len(c.finished) + len(c.rejected) == 8
    assert len(c.finished) > 0
    assert check_invariants(c) == []
    for req in c.finished:
        img = c.engine.value_of(req.ref_key(req.graph.outputs["image"]))
        assert tuple(img.shape) == (1, 128, 128, 3) and img.device.type == "cpu"
        assert bool(torch.isfinite(img).all()) and float(img.abs().max()) <= 1.0
    # all three workflows of S1 were served, each fused into a segment
    assert {r.workflow_name for r in c.finished} == {
        "sd3:basic", "sd3:cn1", "sd3:cn2"}
    assert {d.model_id for d in c.dispatch_log
            if d.model_id.startswith("segment:")} == {
        "segment:backbone:sd3", "segment:backbone:sd3+controlnet1:sd3",
        "segment:backbone:sd3+controlnet1:sd3+controlnet2:sd3"}


def test_local_plane_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(tserve.parse_args(["--plane", "local"]))


def test_module_runs_as_a_script():
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--plane", "sim",
         "--duration", "20"], env=dict(os.environ, PYTHONPATH=src),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0].startswith("requests: ")
