"""Where a dry run's per-partition FLOPs and collective bytes go, by aten
operation and operand shapes (``repro_torch.launch.dryrun``).

Usage::

    PYTHONPATH=src python tools/dryrun_breakdown.py --arch llama3-8b \\
        --layers 1 --accum 4 --shape train_4k [--multi-pod] [--top 14]

The depth is cut to ``--layers`` and the accumulation steps set to
``--accum``, so that one layer's operations show at the production
mesh's local shapes; the torch version leads the output, since each
version's ``DTensor`` rules choose their own plan."""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--accum", type=int, default=4)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    print(f"torch {torch.__version__}")
    cfg = dataclasses.replace(ARCHS[args.arch], n_layers=args.layers)
    dryrun.accum_steps_for = lambda *_: args.accum
    flops, coll = {}, {}
    count = op_cost.OpCost.__torch_dispatch__

    def by_op(self, func, types, args_=(), kwargs=None):
        f0, c0 = self.flops, sum(self.collectives.values())
        out = count(self, func, types, args_, kwargs)
        key = (str(func), tuple(tuple(a.shape) for a in args_
                                if isinstance(a, torch.Tensor)))
        if self.flops != f0:
            flops[key] = flops.get(key, 0.0) + self.flops - f0
        c = sum(self.collectives.values())
        if c != c0:
            coll[key] = coll.get(key, 0.0) + c - c0
        return out

    op_cost.OpCost.__torch_dispatch__ = by_op
    run, meta = dryrun.build_step(cfg, args.shape, multi_pod=args.multi_pod)
    r = dryrun.analyze(run, meta)
    print(f"{cfg.name} x {args.shape} x {r['mesh']}, {args.layers} layer(s), "
          f"accumulation {args.accum}: flops {r['flops']:.4e}, collectives "
          f"{r['collectives']}")
    for key, v in sorted(flops.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"flops {v:.3e} {key}")
    for key, v in sorted(coll.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"collective bytes {v:.3e} {key}")


if __name__ == "__main__":
    main()
