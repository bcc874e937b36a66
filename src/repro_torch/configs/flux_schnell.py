"""Paper-own diffusion family config (Table 2): flux_schnell."""

from repro_torch.diffusion.config import FLUX_SCHNELL as CONFIG  # noqa: F401
