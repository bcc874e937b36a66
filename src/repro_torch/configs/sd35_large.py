"""Paper-own diffusion family config (Table 2): sd35_large."""

from repro_torch.diffusion.config import SD35_LARGE as CONFIG  # noqa: F401
