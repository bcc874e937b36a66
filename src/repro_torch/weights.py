"""Carry parameter trees across from the JAX package.

:func:`from_numpy` turns a parameter tree given as numpy arrays (nested
dicts and lists, including the layer-stacked ``[L, ...]`` MMDiT leaves) into
the same tree of torch tensors on a given device and, optionally, dtype.
bfloat16 and float8_e4m3fn leaves (numpy's ``ml_dtypes`` extension types)
come across exactly, as do int8 ones.  A quantized ``{"qw", "qs"}`` weight
keeps its types whatever ``dtype`` asks: its int8 or fp8 values and float32
scales are the weight.  A port model takes such a tree as its ``weights``
in place of its own init.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels.quant_matmul.ops import is_quantized


def from_numpy(tree: Any, device: Any = "cpu",
               dtype: Optional[torch.dtype] = None) -> Any:
    if is_quantized(tree):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":     # exact: bf16 widens to f32 losslessly
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":   # the same bits, reinterpreted
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(np.array(arr))   # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_device(tree: Any, device: Any) -> Any:
    """The same tree with every tensor leaf on ``device`` (the leaf itself
    where it lies there already) and every ``torch.device`` leaf replaced
    by ``device``: a model's components name their device with such a
    leaf, so a moved tree names its new home."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, torch.device):
        return torch.device(device)
    return tree
