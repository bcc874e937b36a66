"""The port's encoder-decoder family against the JAX package's, on the
CPU: whisper-tiny at ``reduced()`` (2 encoder layers over 16 frames, 2
decoder layers), f32, within 1e-4 relative
(``test_torch_models_dense.check_family``).

The encoder's attention is non-causal and mask-free, so both packages
route it to flash attention: the JAX package's Pallas kernel in interpret
mode, the port's plain version (a CPU tensor).  The decoder's causal
self-attention and its cross-attention (32 tokens against 16 frames, or
one decode token against them) take the plain path.  Decoding reads the encoder's output
from the cache, set to the same draw in both."""

from repro.nn.layers import flash_attention_enabled as jax_flash_enabled
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.nn.layers import flash_attention_enabled, set_flash_attention
from test_torch_models_dense import check_family


def test_whisper_matches_jax():
    assert jax_flash_enabled() and flash_attention_enabled()
    before = flash_attention.launches
    check_family("whisper-tiny")
    assert flash_attention.launches == before     # CPU: the plain version


def test_whisper_plain_attention_route_matches_jax():
    """The port's plain attention route (flash off) against the JAX
    package's flash route: the routes agree within the same tolerance."""
    prev = set_flash_attention(False)
    try:
        check_family("whisper-tiny")
    finally:
        set_flash_attention(prev)
    assert flash_attention_enabled() == prev
