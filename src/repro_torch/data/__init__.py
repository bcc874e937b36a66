"""Synthetic data pipeline."""

from repro_torch.data.pipeline import DataConfig, SyntheticLM
