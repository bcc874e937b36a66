"""Flash attention: the Hopper kernel, its plain version and the [B, S, H, D] wrapper."""
