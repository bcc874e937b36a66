"""The port's CUDA kernel on the card, against its plain version.

Marked ``cuda``: these tests skip where no CUDA device is present, and run
on a machine with one (``python -m pytest -q -m cuda tests/test_torch_cuda.py``).
The file imports only the port, so it runs where JAX is not installed.
Tolerances: f32 atol 2e-5, bf16 3e-2 (the JAX package's kernel grid)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

GRID = [
    ((2, 128, 128, 64), False, None),
    ((2, 256, 256, 32), True, None),
    ((1, 200, 200, 16), True, 64),       # ragged + sliding window
    ((1, 64, 256, 64), False, None),     # cross-attention shape
    ((2, 100, 300, 8), False, 128),
    ((2, 72, 72, 16), False, None),      # toy MMDiT joint attention
    ((2, 40, 40, 1024), False, None),    # text-encoder head dim
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window", GRID)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_kernel_matches_plain_version(card, shape, causal, window, dtype, atol):
    bh, sq, sk, d = shape
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, n, d)).astype(np.float32))
               .to(card, dtype) for n in (sq, sk, sk))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=atol)
