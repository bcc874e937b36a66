"""Training substrate: optimizer, checkpointing, loop."""

from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import (
    AdafactorState,
    AdamWConfig,
    AdamWState,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
)


def __getattr__(name):
    # lazy: loop imports models.steps, which imports this package
    if name in ("TrainConfig", "train"):
        from repro_torch.train import loop
        return getattr(loop, name)
    raise AttributeError(name)
