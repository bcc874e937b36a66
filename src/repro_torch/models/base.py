"""Architecture configs for the assigned model zoo.

One :class:`ArchConfig` describes any of the six architecture families
(dense GQA, MoE, SSM, hybrid, enc-dec audio, VLM).  Every config cites its
source in ``citation``.  ``reduced()`` produces the CPU-smoke-test variant
(≤2 layers, d_model ≤ 512, ≤4 experts) of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str               # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    citation: str = ""
    head_dim: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- attention flavour ---
    qk_norm: bool = False
    sliding_window: Optional[int] = None    # native SWA (danube, rg local attn)
    swa_decode_variant: bool = False        # long_500k ring-buffer carve-out
    rope_theta: float = 10000.0
    # --- ssm / hybrid ---
    block_pattern: Tuple[str, ...] = ()     # e.g. ("rglru","rglru","attn")
    ssm_chunk: int = 256                    # chunked linear-attention chunk
    # --- enc-dec (audio) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0                    # whisper: 1500 mel frames
    # --- vlm ---
    frontend_tokens: int = 0                # patch embeds per image
    frontend_dim: int = 0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 512 so embeddings/lm_head/logits
        shard over the 16-way (and 2x16 multi-pod) model axis — standard
        framework practice (odd vocabs like 92553 otherwise force the
        [B,S,V] loss logits to replicate)."""
        return ((self.vocab + 511) // 512) * 512

    # ------------------------------------------------------------- params
    def param_count(self) -> float:
        """Analytic parameter count (drives MODEL_FLOPS and roofline)."""
        d, dff, hd = self.d_model, self.d_ff, self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.arch_type == "moe":
            mlp = 3 * d * dff * self.n_experts + d * self.n_experts  # + router
        elif self.arch_type == "ssm":
            # mLSTM: qkv + out + gates (approx 8 d^2 per block)
            mlp, attn = 4 * d * d, 4 * d * d
        elif self.arch_type == "hybrid":
            # mix of RG-LRU blocks (~4 d^2 + conv) and local-attn blocks
            mlp = 3 * d * dff
        else:
            mlp = 3 * d * dff if dff else 0
        body = self.n_layers * (attn + mlp + 2 * d)
        embed = self.vocab * d * 2            # embed + head (untied)
        if self.is_encoder_decoder:
            enc = self.encoder_layers * (attn + 2 * (d * 4 * d) + 2 * d)
            cross = self.n_layers * attn      # cross-attention
            body += enc + cross
        if self.frontend_tokens:
            body += self.frontend_dim * d     # projector
        return float(body + embed)

    def active_param_count(self) -> float:
        """Activated parameters per token (MoE: only routed experts)."""
        if self.arch_type != "moe" or not self.n_experts:
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        dense_moe = self.n_layers * 3 * d * dff * self.n_experts
        active_moe = self.n_layers * 3 * d * dff * self.experts_per_token
        return self.param_count() - dense_moe + active_moe

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant of the same family."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, max(1, heads // 2))
        pattern = self.block_pattern[: 2] if self.block_pattern else ()
        return dataclasses.replace(
            self,
            name=f"{self.name}-reduced",
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 1024),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            sliding_window=min(self.sliding_window, 16)
            if self.sliding_window else None,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            frontend_tokens=min(self.frontend_tokens, 8)
            if self.frontend_tokens else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            block_pattern=pattern,
            ssm_chunk=32,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
