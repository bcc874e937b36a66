"""Per-step logit error of the port's recurrentgemma-2b decode from the
default (bf16) decode caches against the JAX package's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/hybrid_decode_bf16.py [--threads N]

Runs ``tests/test_torch_models_dense.check_decode`` (16 steps, the tests'
1e-4 gate) at 2 and 4 layers and prints, for each depth, the relative
error (max |difference| / max |reference| over the vocabulary) at every
step.  Imports both packages, like the tests.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)

    import torch

    import test_torch_models_dense as td

    if args.threads:
        torch.set_num_threads(args.threads)
    seen = []
    measure = td.rel

    def rel(got, want, vocab=None):
        seen.append(measure(got, want, vocab))
        return seen[-1]

    td.rel = rel
    for layers in (2, 4):
        jcfg, tcfg = td.configs("recurrentgemma-2b", n_layers=layers)
        jparams, tparams = td.check_forward("recurrentgemma-2b", jcfg, tcfg)
        seen.clear()
        td.check_decode("recurrentgemma-2b", jcfg, tcfg, jparams, tparams,
                        dtype="bfloat16")
        print(f"{layers} layers, torch threads {torch.get_num_threads()}: "
              f"worst {max(seen):.3e}; by step "
              + " ".join(f"{v:.1e}" for v in seen))
    return 0


if __name__ == "__main__":
    sys.exit(main())
