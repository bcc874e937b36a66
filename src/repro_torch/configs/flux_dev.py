"""Paper-own diffusion family config (Table 2): flux_dev."""

from repro_torch.diffusion.config import FLUX_DEV as CONFIG  # noqa: F401
