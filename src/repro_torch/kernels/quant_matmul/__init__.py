"""Quantized (w8a8 int8 / fp8 weight-only) matmul: the Hopper int8 kernels
(row quantization and product), their plain versions and the quantize
helpers."""

from repro_torch.kernels.quant_matmul.ops import (
    dequantize_weight,
    is_quantized,
    quant_apply,
    quantize_weight,
)

__all__ = ["dequantize_weight", "is_quantized", "quant_apply",
           "quantize_weight"]
