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
the RG-LRU scan's wrapper, the MoE routing) under a ``DTensor`` trace:
each input is redistributed so that only the dimensions the function can
split stay sharded, the function runs on the local shards (the
counterpart of a ``shard_map`` around the Pallas call, or of a ``vmap``
XLA partitions along its mapped dim), and the results come back as
``DTensor`` s.  :func:`on_labelled_shards` does the same for inputs and
results whose dims differ, named as in an einsum (the MoE router's
products and its scatter into the expert buffers).
"""

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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
                    shardable: Sequence[int], n_out: int = 1,
                    spread: Optional[Sequence[int]] = None) -> Any:
    """``fn(*tensors)``, on the local shards where the inputs are
    ``DTensor`` s.  Each mesh dim splits the inputs along the dim of
    ``shardable`` the first input is split along there, where it splits
    evenly in every input; else along the dim of ``spread`` (``shardable``
    if not given) whose size shares the largest factor with the mesh dim
    (the first of equals), as many ways as they share: where that is
    fewer than the mesh dim's size, each part is done by that many ranks
    in copy and the parts are gathered after (XLA's split of 38 heads
    over a 4-way axis); else the inputs are replicated there.  ``fn``'s
    ``n_out`` results come back as ``DTensor`` s placed as the inputs.
    Plain tensors go straight to ``fn``."""
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dts = [t for t in tensors if is_dtensor(t)]
    mesh = dts[0].device_mesh
    spread = shardable if spread is None else spread
    ways: Dict[int, int] = {}           # tensor dim -> ways split so far
    keep, parts = [], {}                # parts: mesh dim -> (dim, ways)
    for i, p in enumerate(dts[0].placements):
        m = mesh.size(i)
        d = p.dim if isinstance(p, Shard) and p.dim in shardable else None
        if d is not None and all(
                t.shape[d] % (ways.get(d, 1) * m) == 0 for t in dts):
            ways[d] = ways.get(d, 1) * m
            keep.append(Shard(d))
            continue
        shares = [(math.gcd(m, *(t.shape[d] // ways.get(d, 1)
                                 for t in dts)), d) for d in spread]
        g, d = max(shares, key=lambda s: s[0], default=(1, None))
        if g == 1:
            keep.append(Replicate())
            continue
        ways[d] = ways.get(d, 1) * g
        keep.append(Shard(d))
        if g < m:
            parts[i] = (d, g)
    # the copies of a part take the inputs whole on that mesh dim and cut
    # their part out, so that an input's gradient is a part of the sum
    in_keep = [Replicate() if i in parts else p for i, p in enumerate(keep)]
    grad_keep = [Partial() if i in parts else p for i, p in enumerate(in_keep)]

    def local(*xs):
        xs = list(xs)
        for i, (d, g) in parts.items():
            part = mesh.get_local_rank(i) // (mesh.size(i) // g)
            for j, t in enumerate(tensors):
                if is_dtensor(t):
                    n = xs[j].shape[d] // g
                    xs[j] = xs[j].narrow(d, part * n, n)
        return fn(*xs)

    # a list of placements per tensor: a tuple reads as one per output
    places = tuple(in_keep if is_dtensor(t) else None for t in tensors)
    grads = tuple(grad_keep if is_dtensor(t) else None for t in tensors)
    outs = keep if n_out == 1 else (keep,) * n_out
    out = local_map(local, out_placements=outs, in_placements=places,
                    in_grad_placements=grads, device_mesh=mesh,
                    redistribute_inputs=True)(*tensors)
    if not parts:
        return out
    gathered = [_gather_parts(o, parts)
                for o in ((out,) if n_out == 1 else out)]
    return gathered[0] if n_out == 1 else tuple(gathered)


def _gather_parts(out: Any, parts: Dict[int, Tuple[int, int]]) -> Any:
    """A result whose dim ``d`` holds, on a mesh dim of ``m`` ranks, ``g``
    parts each done by ``m / g`` ranks in copy: gathered over that mesh
    dim, and one copy of each part kept."""
    from torch.distributed.tensor import Replicate

    for i, (d, g) in parts.items():
        place = list(out.placements)
        place[i] = Replicate()
        out = out.redistribute(out.device_mesh, place)
        copies = out.device_mesh.size(i) // g
        out = out.unflatten(d, (g, copies, -1)).select(d + 1, 0)
        out = out.flatten(d, d + 1)
    return out


def on_labelled_shards(fn: Callable, tensors: Sequence[Any],
                       signature: str, split: str) -> Any:
    """``fn(*tensors)`` on the local shards, for inputs and results whose
    dims ``signature`` names as an einsum equation does (``"gtd,de->gte"``:
    a product over the groups ``g``).  Each mesh dim splits, along the
    label of ``split`` that the first input is split along there, every
    tensor that has that label, and replicates the others; a result that
    lacks the label holds partial sums there, all-reduced after (XLA's
    row-parallel product), and so does the gradient of an input that lacks
    it.  Plain tensors go straight to ``fn``."""
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ins, outs = signature.split("->")
    ins, outs = ins.split(","), outs.split(",")
    first = tensors[0]
    mesh = first.device_mesh
    size = {c: n for t, s in zip(tensors, ins) for c, n in zip(s, t.shape)}
    ways: Dict[str, int] = {}
    labels = []                         # per mesh dim: the label split
    for i, p in enumerate(first.placements):
        c = ins[0][p.dim] if isinstance(p, Shard) else None
        if c is None or c not in split or size[c] % (ways.get(c, 1)
                                                     * mesh.size(i)):
            labels.append(None)
            continue
        ways[c] = ways.get(c, 1) * mesh.size(i)
        labels.append(c)

    def place(s, lacking):
        return [Replicate() if c is None else Shard(s.index(c)) if c in s
                else lacking for c in labels]

    in_place = tuple(place(s, Replicate()) if is_dtensor(t) else None
                     for t, s in zip(tensors, ins))
    grads = tuple(place(s, Partial()) if is_dtensor(t) else None
                  for t, s in zip(tensors, ins))
    out_place = [place(s, Partial()) for s in outs]
    out = local_map(fn, out_placements=out_place[0] if len(outs) == 1
                    else tuple(out_place), in_placements=in_place,
                    in_grad_placements=grads, device_mesh=mesh,
                    redistribute_inputs=True)(*tensors)
    return all_reduced(out) if len(outs) == 1 else tuple(
        all_reduced(o) for o in out)


def all_reduced(x: Any) -> Any:
    """``x`` with its partial sums all-reduced (XLA's layout of a
    row-parallel product's result)."""
    from torch.distributed.tensor import Partial, Replicate

    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])
