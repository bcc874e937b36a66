"""Minimal dependency-free checkpointing (numpy .npz + tree manifest).

Saves and restores trees of tensors (parameters and optimizer state) with
their structure recorded as flattened key paths, the JAX package's own
(``0/embed``, ``1/mu/blocks/wq``, ``1/step``): a checkpoint written by
either package restores into the other's template.  Atomic via a tmp
directory renamed into place; keeps the last ``keep`` checkpoints.
bfloat16 leaves are stored as their 2-byte patterns, as the JAX package's
numpy arrays store them (numpy has no bfloat16 of its own).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import paths, unflatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bfloat16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in paths(tree)}


def _treedef(tree: Any) -> str:
    """A readable record of the structure (the manifest's ``treedef``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__ + "(" + ", ".join(
            f"{f}={_treedef(c)}" for f, c in zip(tree._fields, tree)) + ")")
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(c) for c in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "None" if tree is None else "*"


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    tmp = tempfile.mkdtemp(dir=directory)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "treedef": _treedef(tree),
                   "keys": sorted(flat)}, f)
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1])


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (shape-checked): each
    leaf a new tensor of the template leaf's dtype on its device."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    arrays = np.load(os.path.join(path, "arrays.npz"))
    restored = []
    for key, ref in paths(template):
        got = arrays[key]
        if tuple(got.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint {got.shape} != template "
                             f"{tuple(ref.shape)}")
        restored.append(_to_tensor(got, ref))
    return unflatten(template, restored), step
