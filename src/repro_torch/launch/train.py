"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Reduced configuration by default (``--reduced``), the published one with
``--full``; on the CUDA card unless ``--device cpu`` asks for the CPU.

    python -m repro_torch.launch.train --arch whisper-tiny --steps 3 --device cpu
    python -m repro_torch.launch.train --arch whisper-tiny --full --steps 3
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig
    from repro_torch.train import TrainConfig, train

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    out = train(
        cfg,
        DataConfig(batch_size=args.batch, seq_len=args.seq),
        TrainConfig(steps=args.steps, optimizer=args.optimizer,
                    checkpoint_dir=args.checkpoint_dir),
        device=args.device,
    )
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(first: {out['losses'][0]:.4f})")


if __name__ == "__main__":
    main()
