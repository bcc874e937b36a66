"""Paper-own diffusion family config (Table 2): sdxl."""

from repro_torch.diffusion.config import SDXL as CONFIG  # noqa: F401
