"""Assigned-architecture registry: ``--arch <id>`` resolution."""

from repro_torch.configs import (
    granite_moe_1b_a400m,
    grok1_314b,
    h2o_danube3_4b,
    internvl2_2b,
    llama3_8b,
    qwen3_1_7b,
    recurrentgemma_2b,
    whisper_tiny,
    xlstm_1_3b,
    yi_34b,
)
from repro_torch.models.base import INPUT_SHAPES, ArchConfig, InputShape

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        llama3_8b, granite_moe_1b_a400m, internvl2_2b, h2o_danube3_4b,
        yi_34b, xlstm_1_3b, whisper_tiny, qwen3_1_7b, grok1_314b,
        recurrentgemma_2b,
    )
}

# documented skips (DESIGN.md section 4): whisper has no meaningful 500k
# decode (448-token real decoder context, fixed 1500-frame encoder)
SKIPS = {("whisper-tiny", "long_500k"): "enc-dec ASR; 448-token real decoder context"}


# the paper's own diffusion families are selectable too (serving plane)
from repro_torch.diffusion.config import FAMILIES as DIFFUSION_FAMILIES  # noqa: E402


def get_config(name: str):
    if name in ARCHS:
        return ARCHS[name]
    return DIFFUSION_FAMILIES[name]


def pairs():
    """All (arch, shape) dry-run pairs minus documented skips."""
    out = []
    for a in ARCHS:
        for s in INPUT_SHAPES:
            if (a, s) not in SKIPS:
                out.append((a, s))
    return out
