"""The kernels' meta routes: what the dry run traces in place of a launch.

The dry run (:mod:`repro_torch.launch.dryrun`) runs a step on the ``meta``
device, where nothing is computed.  A kernel wrapper handed meta tensors
calls the operator here instead of its CUDA kernel or its plain version:
a ``torch.library`` custom operator whose fake implementation returns
outputs of the right shape and dtype, and whose registered FLOP formula
tells :mod:`repro_torch.launch.op_cost` what the kernel would do.  Only
meta tensors reach these operators (their real implementation raises), no
launch is counted, and the CUDA and CPU routes are unchanged.

FLOPs are counted as the JAX package's HLO counts them: flash attention's
forward as its two products, ``4 BH Sq Sk D``, its backward as the VJP of
the plain attention, five products, ``10 BH Sq Sk D``; the RG-LRU scan is
elementwise and counts none.

:func:`on_local_shards` runs a function of plain tensors (the attention,
the RG-LRU scan's wrapper) under a ``DTensor`` trace: each input is
redistributed so that only the dimensions the function can split stay
sharded, the function runs on the local shards (the counterpart of a
``shard_map`` around the Pallas call), and the results come back as
``DTensor`` s.
"""

from typing import Any, Callable, Dict, Sequence, Tuple

import torch
from torch import Tensor

_OPS: Dict[str, Any] = {}


def _refuse(*_: Any) -> Any:
    raise RuntimeError("a meta route takes meta tensors only")


def _register() -> Dict[str, Any]:
    """Define the operators and their FLOP formulas (once per process)."""
    if _OPS:
        return _OPS
    from torch.library import custom_op
    from torch.utils.flop_counter import register_flop_formula

    @custom_op("repro_torch::flash_attention_meta", mutates_args=())
    def fwd(q: Tensor, k: Tensor, v: Tensor,
            with_lse: bool) -> Tuple[Tensor, Tensor]:
        return _refuse()

    @fwd.register_fake
    def _(q, k, v, with_lse):
        lse_shape = q.shape[:2] if with_lse else (0,)
        return (torch.empty_like(q),
                q.new_empty(lse_shape, dtype=torch.float32))

    @custom_op("repro_torch::flash_attention_bwd_meta", mutates_args=())
    def bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
            do: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        return _refuse()

    @bwd.register_fake
    def _(q, k, v, o, lse, do):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    @custom_op("repro_torch::rglru_scan_meta", mutates_args=())
    def scan(a: Tensor, x: Tensor) -> Tensor:
        return _refuse()

    @scan.register_fake
    def _(a, x):
        return torch.empty_like(a)

    @custom_op("repro_torch::rglru_scan_bwd_meta", mutates_args=())
    def scan_bwd(a: Tensor, x: Tensor, h: Tensor,
                 dh: Tensor) -> Tuple[Tensor, Tensor]:
        return _refuse()

    @scan_bwd.register_fake
    def _(a, x, h, dh):
        return torch.empty_like(a), torch.empty_like(x)

    def attn_flops(q_shape, k_shape, products):
        bh, sq, d = q_shape
        return 2 * products * bh * sq * k_shape[1] * d

    @register_flop_formula(torch.ops.repro_torch.flash_attention_meta)
    def _(q_shape, k_shape, *_, out_shape=None, **__):
        return attn_flops(q_shape, k_shape, 2)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd_meta)
    def _(q_shape, k_shape, *_, out_shape=None, **__):
        return attn_flops(q_shape, k_shape, 5)

    _OPS.update(fwd=fwd, bwd=bwd, scan=scan, scan_bwd=scan_bwd)
    return _OPS


def flash_attention(q, k, v, return_lse: bool = False) -> Any:
    out, lse = _register()["fwd"](q, k, v, return_lse)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, lse, do) -> tuple:
    return _register()["bwd"](q, k, v, o, lse, do)


def rglru_scan(a, x):
    return _register()["scan"](a, x)


def rglru_scan_bwd(a, x, h, dh) -> tuple:
    return _register()["scan_bwd"](a, x, h, dh)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a ``DTensor`` (without importing the distributed
    package for a plain tensor)."""
    return type(x) is not torch.Tensor and type(x).__name__ == "DTensor"


def on_local_shards(fn: Callable, tensors: Sequence[Any],
                    shardable: Sequence[int], n_out: int = 1) -> Any:
    """``fn(*tensors)``, on the local shards where the inputs are
    ``DTensor`` s: each mesh dim splits the inputs along one of the dims
    in ``shardable`` (the dim the first input is split along there if it
    may, else the first that splits evenly in every input), or replicates
    them where none does; ``fn``'s ``n_out`` results come back as
    ``DTensor`` s placed alike.  Plain tensors go straight to ``fn``."""
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dts = [t for t in tensors if is_dtensor(t)]
    mesh = dts[0].device_mesh
    split = {}                          # tensor dim -> ways split so far
    keep = []
    for i, p in enumerate(dts[0].placements):
        first = [p.dim] if isinstance(p, Shard) and p.dim in shardable else []
        for d in first + list(shardable):
            ways = split.get(d, 1) * mesh.size(i)
            if all(t.shape[d] % ways == 0 for t in dts):
                split[d] = ways
                keep.append(Shard(d))
                break
        else:
            keep.append(Replicate())
    # a list of placements per tensor: a tuple reads as one per output
    places = tuple(keep if is_dtensor(t) else None for t in tensors)
    outs = keep if n_out == 1 else (keep,) * n_out
    return local_map(fn, out_placements=outs, in_placements=places,
                     device_mesh=mesh, redistribute_inputs=True)(*tensors)
