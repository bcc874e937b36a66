"""Training loop driver: data pipeline -> train step -> checkpoints.

Runs on the CUDA card unless the caller asks for the CPU (``device``); it
raises where no card is present rather than falling back.  The initial
parameters are drawn on the device from ``torch.Generator(device)`` seeded
with the data seed (another stream of numbers than the JAX package's
``PRNGKey``), or restored from ``checkpoint_dir`` when a step is there: a
checkpoint of either package carries the same state across.  A restored
run first draws and drops the batches of the steps already taken, so it
goes on with the batches the uninterrupted run would have seen and ends
with its parameters bit for bit; the JAX package's loop restarts the
stream and feeds a resumed run the first batches again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.api import get_family
from repro_torch.models.base import ArchConfig
from repro_torch.models.steps import make_train_step
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import AdamWConfig, adafactor_init, adamw_init


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    optimizer: str = "adamw"
    accum_steps: int = 1
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def device_batch(batch: Dict[str, Any], device: Any) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(cfg: ArchConfig, data_cfg: DataConfig, tcfg: TrainConfig,
          log: Callable[[str], None] = print,
          device: Any = "cuda") -> Dict[str, Any]:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device available (pass "
                           "device='cpu' to train on the CPU)")
    fam = get_family(cfg)
    gen = torch.Generator(device).manual_seed(data_cfg.seed)
    params = fam.init(gen, cfg, device=device)
    init_opt = adamw_init if tcfg.optimizer == "adamw" else adafactor_init
    opt_state = init_opt(params)
    start = 0
    if tcfg.checkpoint_dir and latest_step(tcfg.checkpoint_dir) is not None:
        (params, opt_state), start = restore_checkpoint(
            tcfg.checkpoint_dir, (params, opt_state))
        log(f"restored checkpoint at step {start}")

    step_fn = make_train_step(cfg, opt_cfg=tcfg.opt,
                              accum_steps=tcfg.accum_steps,
                              optimizer=tcfg.optimizer)
    pipe = iter(SyntheticLM(cfg, data_cfg))
    for _ in range(start):          # the batches of the steps already taken
        next(pipe)
    losses: List[float] = []
    t0 = time.perf_counter()
    tokens_per_step = data_cfg.batch_size * data_cfg.seq_len
    for step in range(start, tcfg.steps):
        batch = device_batch(next(pipe), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if (step + 1) % tcfg.log_every == 0:
            dt = time.perf_counter() - t0
            tps = tokens_per_step * tcfg.log_every / dt
            log(f"step {step+1:5d}  loss {loss:7.4f}  "
                f"lr {float(metrics['lr']):.2e}  {tps:,.0f} tok/s")
            t0 = time.perf_counter()
        if tcfg.checkpoint_dir and (step + 1) % tcfg.checkpoint_every == 0:
            save_checkpoint(tcfg.checkpoint_dir, step + 1, (params, opt_state))
    return {"params": params, "opt_state": opt_state, "losses": losses}
