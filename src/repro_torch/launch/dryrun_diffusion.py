"""Dry run of the paper's own models: one CFG denoising step of the
real-scale MMDiT backbone on the production mesh, the counterpart of
``repro.launch.dryrun_diffusion``.

Latent (CFG) parallelism appears here as the batch dimension carrying
both guidance branches (2B rows over the ``data`` axis, the general form
of the paper's 2-GPU split), with tensor parallelism over ``model``.  The
step is traced on the ``meta`` device as in :mod:`repro_torch.launch.dryrun`;
the geometries are :data:`repro_torch.diffusion.config.REAL`.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun_diffusion --family sd3
    PYTHONPATH=src python -m repro_torch.launch.dryrun_diffusion --all
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.diffusion.config import REAL
from repro_torch.diffusion.mmdit import init_mmdit, mmdit_apply
from repro_torch.launch.dryrun import (analyze, distribute, distribute_tree,
                                       meta_tree, partitioned)
from repro_torch.launch.mesh import axis_names, axis_sizes, make_production_mesh
from repro_torch.launch.sharding import P, leaves, map_with_path

_DOWN = ("wo", "w2", "final_proj")


def _specs(params: Any) -> Any:
    def spec(path, leaf):
        name = path[-1]
        nd = len(leaf.shape)
        if nd <= 1 or "norm" in name or name.endswith("_b"):
            return P()
        lead = (None,) * (nd - 2)
        if any(k in name for k in _DOWN):
            return P(*lead, "model", None)
        return P(*lead, None, "model")

    return map_with_path(spec, params)


def build(family: str, batch: int = 8, mesh=None
          ) -> Tuple[Callable[[], Any], Dict[str, Any]]:
    """``(run, meta)`` of one CFG denoise step of ``REAL[family]``: the
    JAX package's ``build`` (which returns a lowered step)."""
    cfg = REAL[family]
    mesh = mesh if mesh is not None else make_production_mesh()
    dp = tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
    dp = dp if len(dp) > 1 else dp[0]
    params = meta_tree(init_mmdit, torch.Generator(), cfg)
    b2 = batch * 2                        # CFG: cond + uncond rows

    def arg(shape, dtype, spec):
        return distribute(torch.empty(shape, dtype=dtype, device="meta"),
                          spec, mesh)

    args = (
        distribute_tree(params, _specs(params), mesh),
        arg((b2, cfg.latent_size, cfg.latent_size, cfg.latent_channels),
            torch.bfloat16, P(dp, None, None, None)),
        arg((b2,), torch.float32, P(dp)),
        arg((b2, cfg.text_tokens, cfg.text_dim), torch.bfloat16,
            P(dp, None, None)),
    )

    def run():
        with partitioned():
            return mmdit_apply(args[0], cfg, *args[1:])

    n_params = sum(t.numel() for t in leaves(params))
    meta = {"arch": f"diffusion:{family}", "shape": f"denoise_b{batch}_cfg",
            "mesh": "x".join(str(n) for n in axis_sizes(mesh).values()),
            "kind": "prefill", "params": float(n_params),
            "active_params": float(n_params),
            "arguments": args}
    return run, meta


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    fams = list(REAL) if args.all else [args.family or "sd3"]
    fail = 0
    for f in fams:
        try:
            run, meta = build(f, args.batch)
            r = analyze(run, meta)
            peak = r["bytes_per_device"]["peak"]
            print(f"OK   diffusion:{f}: params={meta['params']/1e9:.1f}B "
                  f"flops/part={r['flops']:.3e} "
                  f"coll={r['collectives'].get('total', 0):.3e} "
                  f"peak/device={peak/2**30:.2f}GiB "
                  f"trace={r['trace_seconds']:.1f}s", flush=True)
        except Exception as e:
            fail += 1
            print(f"FAIL diffusion:{f}: {type(e).__name__}: {e}", flush=True)
    sys.exit(1 if fail else 0)


if __name__ == "__main__":
    main()
