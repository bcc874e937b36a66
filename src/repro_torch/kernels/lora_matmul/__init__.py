"""Fused LoRA matmul: the Hopper kernel (single and grouped), its plain version and the wrappers."""
