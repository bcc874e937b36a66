"""Serving launcher: run the micro-serving system on a workload.

``--plane sim`` replays a trace through the cluster simulator (the paper's
evaluation mode) and never touches a device; ``--plane local`` really
executes the diffusion models through the same coordinator, on the CUDA
card unless ``--device cpu`` asks for the CPU.  The local plane serves the
trace's first 8 requests at 3 denoising steps, as the JAX package's
launcher does.

    python -m repro_torch.launch.serve --setting s1 --plane sim
    python -m repro_torch.launch.serve --plane local --device cpu

:func:`serve` is the library entry point: it takes the parsed arguments
and optional ``model_sets`` (a family name to the
:class:`~repro_torch.diffusion.workflows.ModelSet` to serve it with, e.g.
a full-width family carrying weights drawn once) and returns the
:class:`~repro_torch.core.registry.ServingSystem` after its run.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.core import LocalBackend, ServingSystem
from repro_torch.diffusion import ModelSet, table2_setting
from repro_torch.sim import generate_trace


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--setting", default="s1",
                    choices=["s1", "s2", "s3", "s4", "s5", "s6"])
    ap.add_argument("--plane", default="sim", choices=["sim", "local"])
    ap.add_argument("--executors", type=int, default=8)
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--cv", type=float, default=2.0)
    ap.add_argument("--slo-scale", type=float, default=2.0)
    ap.add_argument("--no-admission", action="store_true")
    # the port's own: where --plane local executes (no CPU fallback)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace,
          model_sets: Optional[Dict[str, ModelSet]] = None) -> ServingSystem:
    """Build the system for ``args``, replay the trace and return it."""
    wfs = table2_setting(args.setting, model_sets=model_sets)
    local = args.plane == "local"
    backend = LocalBackend(device=args.device) if local else None
    sys_ = ServingSystem(n_executors=args.executors,
                         admission_enabled=not args.no_admission,
                         backend=backend)
    for t in wfs.values():
        sys_.register(t)
    solo = {n: sys_.solo_latency(n) for n in wfs}
    trace = generate_trace(list(wfs), rate=args.rate, duration=args.duration,
                           cv=args.cv, seed=0)
    kw = {"steps": 3} if local else {}
    for t in trace[: (8 if local else None)]:
        sys_.submit(t.workflow, inputs=t.inputs, arrival=t.arrival,
                    slo_seconds=args.slo_scale * solo[t.workflow], **kw)
    sys_.run()
    return sys_


def main(argv: Optional[Sequence[str]] = None) -> None:
    sys_ = serve(parse_args(argv))
    c = sys_.coordinator
    print(f"requests: {len(c.finished)} done, {len(c.rejected)} rejected")
    print(f"SLO attainment: {sys_.slo_attainment():.3f}")
    print(f"mean latency: {sys_.mean_latency():.3f}s  p99: {c.p99_latency():.3f}s")
    print(f"dispatches: {len(c.dispatch_log)}  "
          f"transfers: {c.engine.num_transfers} "
          f"({c.engine.bytes_transferred/2**30:.2f} GiB)")


if __name__ == "__main__":
    main()
