"""Paper-own diffusion family config (Table 2): sd3."""

from repro_torch.diffusion.config import SD3 as CONFIG  # noqa: F401
