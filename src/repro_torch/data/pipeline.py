"""Synthetic token data pipeline.

Deterministic, seedable, infinite stream of LM batches with a
Zipfian-mixture token distribution (so losses have realistic structure
instead of uniform noise) plus the stub modality frontends (frame/patch
embeddings) for the enc-dec/VLM architectures.  Implements shard-aware
iteration: each data-parallel host pulls only its slice.

The JAX package's pipeline, kept as the port's own copy: numpy only, so
the same seed and shard give the same batches bit for bit.  Batches are
numpy arrays on the host; the training loop moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    zipf_alpha: float = 1.1
    # shard-aware iteration
    shard_index: int = 0
    shard_count: int = 1


class SyntheticLM:
    """Markov-ish synthetic corpus: next token correlates with current
    (a fixed random bigram table over a Zipfian unigram prior)."""

    def __init__(self, cfg: ArchConfig, data: DataConfig) -> None:
        assert data.batch_size % data.shard_count == 0
        self.cfg = cfg
        self.data = data
        self.rng = np.random.default_rng(data.seed + data.shard_index)
        v = cfg.vocab
        ranks = np.arange(1, min(v, 4096) + 1, dtype=np.float64)
        p = ranks ** (-data.zipf_alpha)
        self.unigram = p / p.sum()
        self.vocab_head = len(self.unigram)
        # sparse bigram jump table: each token prefers 8 successors
        self.succ = self.rng.integers(0, self.vocab_head,
                                      size=(self.vocab_head, 8))

    def _sample_row(self, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        tok = self.rng.choice(self.vocab_head, p=self.unigram)
        for i in range(length):
            out[i] = tok
            if self.rng.random() < 0.7:
                tok = self.succ[tok, self.rng.integers(8)]
            else:
                tok = self.rng.choice(self.vocab_head, p=self.unigram)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        b = self.data.batch_size // self.data.shard_count
        s = self.data.seq_len
        while True:
            tokens = np.stack([self._sample_row(s + 1) for _ in range(b)])
            batch: Dict[str, np.ndarray] = {
                "tokens": tokens[:, :-1].astype(np.int32),
                "labels": tokens[:, 1:].astype(np.int32),
            }
            if self.cfg.is_encoder_decoder:
                batch["frames"] = self.rng.standard_normal(
                    (b, self.cfg.encoder_seq, self.cfg.d_model)
                ).astype(np.float32)
            if self.cfg.frontend_tokens:
                batch["patches"] = self.rng.standard_normal(
                    (b, self.cfg.frontend_tokens, self.cfg.frontend_dim)
                ).astype(np.float32)
            yield batch
