"""Multi-pod dry run: trace every (architecture x input shape) pair on the
production meshes and extract the roofline raw material, the counterpart
of ``repro.launch.dryrun``.

The JAX package lowers and compiles each step for 256 or 512 placeholder
devices and reads its costs from the HLO.  The port has nothing to lower:
it runs the step once on the ``meta`` device, as rank 0 of a fake process
group of 256 or 512 ranks (:mod:`repro_torch.launch.mesh`).  Parameters,
optimizer state, batch and decode cache are meta tensors placed as
``DTensor`` s by the ported sharding rules
(:mod:`repro_torch.launch.sharding`); the activation hooks, at the JAX
package's ``with_sharding_constraint`` sites, ``redistribute`` to the same
layouts; ``DTensor`` lowers every operation to this rank's shards and the
functional collectives a real run would issue, and
:class:`~repro_torch.launch.op_cost.OpCost` counts them.  Nothing is
computed on any device, and no card is needed.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out dryrun.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs import ARCHS, SKIPS, pairs
from repro_torch.kernels.meta import (all_reduced, is_dtensor,
                                      on_local_shards)
from repro_torch.launch import op_cost
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import axis_names, axis_sizes, make_production_mesh
from repro_torch.models import act_sharding
from repro_torch.models.api import get_family
from repro_torch.models.base import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.models.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.train.optimizer import adafactor_init, adamw_init

SERVE_DTYPE = torch.bfloat16
TRAIN_DTYPE = torch.bfloat16          # bf16 params, fp32 AdamW moments
RING_WINDOW = 8192


# Gradient-accumulation policy: keep per-microbatch working set inside
# the device's memory.  What sets it: parameter scale (grok), MoE
# dispatch-buffer tokens (granite), head-count divisibility by the 16-way
# model axis (whisper's 6 and recurrentgemma's 10 heads cannot head-shard
# their attention matrices), and f32 associative-scan temporaries
# (xlstm/rglru).
_ACCUM_OVERRIDE = {
    "grok-1-314b": 16,          # multi-pod uses 8 (see below)
    "granite-moe-1b-a400m": 16,
    "whisper-tiny": 16,
    "internvl2-2b": 4,
    "recurrentgemma-2b": 16,
    "xlstm-1.3b": 4,
}


def accum_steps_for(cfg: ArchConfig, shape: InputShape, multi_pod: bool) -> int:
    if cfg.name == "grok-1-314b" and multi_pod:
        return 8                # microbatch 32 = 1/device on the 32-way dp
    if cfg.name in _ACCUM_OVERRIDE:
        return _ACCUM_OVERRIDE[cfg.name]
    p = cfg.param_count()
    if p > 1e11:
        return 32
    if p > 8e9:
        return 4
    return 1


def input_specs(cfg: ArchConfig, shape: InputShape,
                dtype: torch.dtype = torch.float32
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins (shape and dtype, no storage) for every model
    input."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    out = {"tokens": sds((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = sds((b, s), torch.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = sds((b, cfg.encoder_seq, cfg.d_model), dtype)
    if cfg.frontend_tokens:
        out["patches"] = sds((b, cfg.frontend_tokens, cfg.frontend_dim), dtype)
    return out


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------

def meta_tree(init: Callable, *args: Any, **kwargs: Any) -> Any:
    """``init(*args, **kwargs)``'s tree with every tensor leaf a meta
    tensor of the same shape and dtype: the init runs under a
    ``FakeTensorMode``, so nothing is drawn or allocated (an init that
    draws on its generator's device works as one that takes a device)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = init(*args, **kwargs)
    return shd.map_with_path(
        lambda _, t: (torch.empty(t.shape, dtype=t.dtype, device="meta")
                      if isinstance(t, torch.Tensor) else t), tree)


def placements(spec: Sequence[Any], mesh) -> tuple:
    """The ``DTensor`` placements of a spec on ``mesh``: on each mesh dim,
    ``Shard(i)`` for the tensor dim ``i`` whose entry names it."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dims = [i for i, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute(t: torch.Tensor, spec: Sequence[Any], mesh) -> Any:
    """A meta ``DTensor`` of ``t``'s global shape and dtype, placed by
    ``spec`` (which must split its dims evenly, as sanitized specs do)."""
    from torch.distributed.tensor import DTensor

    sizes = axis_sizes(mesh)
    local = list(t.shape)
    for i, a in enumerate(spec):
        for name in (a if isinstance(a, tuple) else (a,)):
            if name is not None:
                local[i] //= sizes[name]
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), mesh,
        placements(spec, mesh), run_check=False, shape=t.shape,
        stride=t.stride())


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    return shd.map_with_path(
        lambda _, t, s: distribute(t, s, mesh)
        if isinstance(t, torch.Tensor) else t, tree, specs)


def local_bytes(tree: Any, read: Optional[set] = None) -> int:
    """Bytes of this rank's shards of the tensors of ``tree`` (an int leaf,
    the decode cache's position, counts as the JAX package's int32
    scalar); with ``read`` (an :class:`~repro_torch.launch.op_cost.OpCost`'s
    ``reads``), only those of the tensors whose values a step read."""
    total = 0
    for leaf in shd.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            local = getattr(leaf, "_local_tensor", leaf)
            if read is None or op_cost.storage_key(local) in read:
                total += local.numel() * local.element_size()
        elif isinstance(leaf, int):
            total += 4
    return total


def _redistributor(mesh, spec: Sequence[Any]) -> Callable:
    """The activation hook: ``redistribute`` a ``DTensor`` to ``spec``."""
    place = placements(spec, mesh)

    def hook(x):
        if type(x).__name__ != "DTensor" or x.placements == place:
            return x
        return x.redistribute(mesh, place)

    return hook


def _replicated(x: Any, keep_batch: bool) -> Any:
    from torch.distributed.tensor import Replicate, Shard

    if type(x).__name__ != "DTensor":
        return x
    place = tuple(p if keep_batch and isinstance(p, Shard) and p.dim == 0
                  else Replicate() for p in x.placements)
    return x if place == x.placements else x.redistribute(x.device_mesh,
                                                          place)


def _tensor_parallel_product(func, x, w, **kwargs):
    """``x @ w`` for a weight ``w`` [K, N] split as the specs split it,
    laid out as XLA's partitioner lays it out: on the ``model`` axis the
    activation whole along K where ``w`` splits N (column-parallel) and
    split along K where ``w`` splits K (row-parallel, the partial sums
    all-reduced after); on a batch axis that splits ``w`` (FSDP), the
    weight gathered for the product."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not (type(x).__name__ == "DTensor" and type(w).__name__ == "DTensor"
            and w.ndim == 2 and x.ndim >= 2):
        return func(x, w, **kwargs)
    last = x.ndim - 1
    place, w_place = [], []
    for name, px, pw in zip(x.device_mesh.mesh_dim_names, x.placements,
                            w.placements):
        if name != "model":
            place.append(px)
            w_place.append(Replicate())
        elif pw == Shard(0):
            place.append(Shard(last))
            w_place.append(pw)
        else:
            place.append(Replicate() if isinstance(px, Partial)
                         or px == Shard(last) else px)
            w_place.append(pw)
    if tuple(place) != tuple(x.placements):
        out = _Regathered.apply(x, w, place, w_place)
    else:
        out = func(x, _placed(w, w_place), **kwargs)
    return all_reduced(out)


def _placed(t, place):
    """``t`` redistributed to ``place`` (a ``Partial`` there read as
    ``Replicate``: a gradient's layout)."""
    from torch.distributed.tensor import Partial, Replicate

    place = tuple(Replicate() if isinstance(p, Partial) else p for p in place)
    return t if tuple(t.placements) == place else t.redistribute(
        t.device_mesh, place)


class _Regathered(torch.autograd.Function):
    """``x @ w`` on ``x`` and ``w`` redistributed to ``place`` and
    ``w_place`` (gathered), saving them as they came: the backward gathers
    them again for the two products of the gradient, as XLA's partitioned
    backward does (its saved residuals are the operands as laid out at the
    layer's boundary, not the gathered copies), with the gradient split
    as the product's result was."""

    @staticmethod
    def forward(ctx, x, w, place, w_place):
        ctx.save_for_backward(x, w)
        out = _placed(x, place) @ _placed(w, w_place)
        ctx.places = place, w_place, out.placements
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        place, w_place, out_place = ctx.places
        xg, wg = _placed(x, place), _placed(w, w_place)
        grad = _placed(grad, out_place)  # split as the product's result
        k, n = wg.shape
        dx = grad @ wg.t()
        dw = xg.reshape(-1, k).t() @ grad.reshape(-1, n)
        return _placed(dx, x.placements), _placed(dw, w.placements), None, None


def _split_on(x: Any, dim: int):
    """The mesh dims that split ``x`` along ``dim`` (none for a plain
    tensor)."""
    from torch.distributed.tensor import Shard

    if type(x).__name__ != "DTensor":
        return []
    dim = dim % x.ndim
    return [i for i, p in enumerate(x.placements) if p == Shard(dim)]


def _log_softmax_split(x, dim: int):
    """``log_softmax`` along a split dim as XLA partitions it: the max and
    the sum reduced across the shards, the result split as ``x`` is (a
    gathered ``x`` is what ``DTensor``'s own rule asks for)."""
    m = x.amax(dim=dim, keepdim=True).detach()
    z = x - m
    return z - torch.log(torch.exp(z).sum(dim=dim, keepdim=True))


def _gather_split(x, dim: int, index):
    """``gather`` along a split dim: each shard gathers the indices that
    fall in its part and zeros elsewhere, and the partial results are
    summed (the vocabulary-parallel loss)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    split = _split_on(x, dim)
    dim = dim % x.ndim
    x_place = list(x.placements)
    i_place = [Replicate() if i in split else p
               for i, p in enumerate(x_place)]
    out_place = [Partial() if i in split else p
                 for i, p in enumerate(x_place)]

    def local(xl, il):
        n = xl.shape[dim]
        il = il - _shard_start(mesh, split) * n
        inside = (il >= 0) & (il < n)
        out = torch.gather(xl, dim, il.clamp(0, n - 1))
        return torch.where(inside, out, 0.0)

    if type(index).__name__ != "DTensor":
        from torch.distributed.tensor import DTensor
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    return local_map(local, out_placements=out_place,
                     in_placements=(x_place, i_place), device_mesh=mesh,
                     redistribute_inputs=True)(x, index)


def _split_reduction(func, args, kwargs):
    """``log_softmax`` or ``gather`` along a dim a ``DTensor`` is split
    on, partitioned (see above); ``None`` for any other call."""
    name = getattr(func, "__name__", "")
    if name not in ("log_softmax", "gather") or not args:
        return None
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if not isinstance(dim, int) or not _split_on(args[0], dim):
        return None
    if name == "log_softmax":
        return _log_softmax_split(args[0], dim)
    index = kwargs.get("index", args[2] if len(args) > 2 else None)
    return _gather_split(args[0], dim, index)


def _einsum_split(equation: str, a, b):
    """``einsum(equation, a, b)`` laid out as XLA's partitioner lays it out
    (``DTensor`` would decompose it into a batched product over a merged
    dim and may gather a split batch dim for it).  On each mesh dim:

    * a dim of ``a`` split there that the result keeps (a batch or free
      dim) stays split, ``b`` split alike on it if it has it, else whole;
    * else such a dim of ``b`` (a weight's output dim: the
      column-parallel product);
    * else a contracted dim split in either is split in both, and the
      partial sums are all-reduced (the row-parallel product);
    * else both are whole.

    An input whole on a mesh dim whose result is split along a dim it
    lacks gets its gradient summed there (a weight's data-parallel
    gradient)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ins, res = equation.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    mesh = (a if is_dtensor(a) else b).device_mesh
    ops = [x if is_dtensor(x) else _as_replicated(x, mesh) for x in (a, b)]
    subs = (sa, sb)
    size = {c: n for x, s in zip(ops, subs) for c, n in zip(s, x.shape)}
    ways: Dict[str, int] = {}
    place = ([], [])
    out = []
    for i in range(mesh.ndim):
        m = mesh.size(i)
        cur = [p.dim if isinstance(p, Shard) else None
               for p in (ops[0].placements[i], ops[1].placements[i])]
        lab = [s[c] if c is not None else None for s, c in zip(subs, cur)]
        pick = next((c for c in lab if c is not None and c in res), None)
        if pick is None:
            pick = next((c for c in lab if c is not None), None)
        if pick is not None and size[pick] % (ways.get(pick, 1) * m):
            pick = None
        if pick is None:
            for k in (0, 1):
                place[k].append(Replicate())
            out.append(Replicate())
            continue
        for k, s in enumerate(subs):
            place[k].append(Shard(s.index(pick)) if pick in s else Replicate())
        ways[pick] = ways.get(pick, 1) * m
        out.append(Shard(res.index(pick)) if pick in res else Partial())
    grads = tuple(
        [Partial() if isinstance(p, Replicate) and isinstance(o, Shard)
         and res[o.dim] not in s else p
         for p, o in zip(place[k], out)] for k, s in enumerate(subs))
    y = local_map(lambda x, z: torch.einsum(equation, x, z),
                  out_placements=out, in_placements=place,
                  in_grad_placements=grads, device_mesh=mesh,
                  redistribute_inputs=True)(*ops)
    return all_reduced(y)


def _as_replicated(x: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _is_einsum(func, args, kwargs) -> bool:
    """Whether the call is ``torch.einsum(equation, a, b)`` with a
    ``DTensor`` among the operands (and no ellipsis)."""
    return (getattr(func, "__name__", "") == "einsum" and not kwargs
            and len(args) == 3 and isinstance(args[0], str)
            and "..." not in args[0] and "->" in args[0]
            and all(isinstance(x, torch.Tensor) for x in args[1:])
            and any(is_dtensor(x) for x in args[1:]))


def _lookup_call(func, args):
    """``(table, index)`` of ``table[index]`` for a ``DTensor`` table split
    along its rows and an integer index (the decode step's embedding
    lookup); ``None`` for any other call."""
    if getattr(func, "__name__", "") != "__getitem__" or len(args) != 2:
        return None
    table, index = args
    if not (is_dtensor(table) and table.ndim == 2
            and isinstance(index, torch.Tensor)
            and not index.dtype.is_floating_point
            and index.dtype != torch.bool and _split_on(table, 0)):
        return None
    return table, index


def _lookup_split(table, index):
    """``table[index]`` for a table split along its rows as XLA partitions
    it: each shard looks up the rows it holds (zeros for the others), and
    the partial rows are all-reduced.  ``DTensor``'s own rule moves the
    table instead (an all-to-all of all its shards), and the activations
    come out split along the model dim, to be gathered again by every
    product after."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    split = _split_on(table, 0)
    if not is_dtensor(index):
        index = _as_replicated(index, mesh)
    t_place = [Shard(0) if i in split else Replicate()
               for i in range(mesh.ndim)]
    i_place = [Replicate() if i in split else p
               for i, p in enumerate(index.placements)]
    out_place = [Partial() if i in split else p for i, p in enumerate(i_place)]
    t_grad = [p if i in split or not isinstance(q, Shard) else Partial()
              for i, (p, q) in enumerate(zip(t_place, i_place))]

    def local(tl, il):
        n = tl.shape[0]
        il = il - _shard_start(mesh, split) * n
        inside = (il >= 0) & (il < n)
        return torch.where(inside[..., None], tl[il.clamp(0, n - 1)], 0.0)

    out = local_map(local, out_placements=out_place,
                    in_placements=(t_place, i_place),
                    in_grad_placements=(t_grad, i_place), device_mesh=mesh,
                    redistribute_inputs=True)(table, index)
    return all_reduced(out)


def _shard_start(mesh, split) -> int:
    """This rank's shard index along a dim split over the mesh dims
    ``split`` (the first the outermost)."""
    start = 0
    for i in split:
        start = start * mesh.size(i) + mesh.get_local_rank(i)
    return start


# what DTensor raises where it has no rule for an operation on its inputs'
# layouts (an in-place write into a plain tensor raises AssertionError)
_REFUSALS = (RuntimeError, NotImplementedError, ValueError, AssertionError)
_NO_RETRY = (torch.autograd.grad, torch.autograd.backward,
             torch.Tensor.backward)


def _local_dims(name: str, args) -> Optional[range]:
    """The dims along which ``name(*args)`` runs on local shards as it
    would on the whole tensor, for the operations ``DTensor`` mishandles:
    ``log_sigmoid``, whose backward it has no rule for, and ``pad`` (the
    chunked scans' padding of the sequence), whose result torch 2.11
    misplaces; ``None`` for any other call."""
    if not args or not is_dtensor(args[0]):
        return None
    if name == "log_sigmoid":
        return range(args[0].ndim)
    if name == "pad" and len(args) > 1:
        return range(args[0].ndim - len(args[1]) // 2)
    return None


class _Partitioner(torch.overrides.TorchFunctionMode):
    """What XLA's partitioner decides where ``DTensor`` would choose
    otherwise or refuse, for the model code's own calls (a rematerialised
    layer's recomputation, which runs in the backward, enters this mode
    again through ``act_sharding``'s ``remat_context``, so that it saves
    what its forward saved):

    * a product with a weight takes the tensor-parallel layout
      (:func:`_tensor_parallel_product`), and its backward gathers the
      activation again (:class:`_Regathered`);
    * a two-operand ``einsum`` keeps its operands' split dims
      (:func:`_einsum_split`), where ``DTensor`` may gather a batch dim;
    * a lookup in a table split along its rows is partitioned
      (:func:`_lookup_split`), where ``DTensor`` would move the table;
    * ``log_softmax`` and ``gather`` along a split dim are partitioned
      (:func:`_split_reduction`), where ``DTensor`` would gather the
      vocabulary-wide logits;
    * ``log_sigmoid`` and ``pad`` run on the local shards
      (:func:`_local_dims`);
    * an operation ``DTensor`` refuses on its inputs' layouts (a reshape
      that splits a dim sharded unevenly, as whisper's 6 heads over a
      16-way axis do) is retried with the inputs replicated outside the
      batch dim, then replicated whole.
    """

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves, tree_map

        kwargs = kwargs or {}
        if func in _NO_RETRY:           # a retry cannot rerun a backward
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        try:
            if name in ("matmul", "__matmul__"):
                return _tensor_parallel_product(func, *args, **kwargs)
            if _is_einsum(func, args, kwargs):
                return _einsum_split(*args)
            lookup = _lookup_call(func, args)
            if lookup is not None:
                return _lookup_split(*lookup)
            dims = _local_dims(name, args)
            if dims is not None:
                return on_local_shards(lambda x: func(x, *args[1:], **kwargs),
                                       (args[0],), dims, spread=())
            out = _split_reduction(func, args, kwargs)
            return func(*args, **kwargs) if out is None else out
        except _REFUSALS as e:
            if not any(type(x).__name__ == "DTensor"
                       for x in tree_leaves((args, kwargs))):
                raise
            err = e
        for keep_batch in (True, False):
            a, k = tree_map(lambda x: _replicated(x, keep_batch),
                            (args, kwargs))
            try:
                return func(*a, **k)
            except _REFUSALS as e:
                err = e
        raise err


@contextlib.contextmanager
def partitioned():
    """The context of a dry-run trace: plain tensors the model makes (rope
    tables, masks) count as replicated, and :class:`_Partitioner`'s
    layouts hold."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication(), _Partitioner():
        yield


# --------------------------------------------------------------------------
# Build
# --------------------------------------------------------------------------

def build_step(arch: Any, shape_name: str, multi_pod: bool = False,
               mesh=None, act_shard: bool = True
               ) -> Tuple[Callable[[], Any], Dict[str, Any]]:
    """Place one (arch x shape x mesh) combination: returns ``(run,
    meta)``, where ``run()`` takes the step once on the placed meta
    arguments under the activation hooks.  The JAX package's counterpart
    is ``build_lowered``: the port has nothing to lower, so it builds the
    step and its arguments instead."""
    cfg = ARCHS[arch] if isinstance(arch, str) else arch
    shape = INPUT_SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    axes = axis_names(mesh)
    dp = tuple(a for a in axes if a in ("pod", "data"))
    dp_spec = dp if len(dp) > 1 else dp[0]
    fam = get_family(cfg)
    kind = shape.kind
    fsdp = shd.needs_fsdp(cfg, kind)

    hook = moe_hook = None
    if act_shard:
        hook = _redistributor(mesh, (dp_spec, None, "model"))
        if cfg.arch_type == "moe":
            ediv = cfg.n_experts % 16 == 0
            # buffers are [G(roups), E, C, d|ff]; groups ride the data axis
            moe_hooks = {
                "dispatch": _redistributor(mesh, (
                    dp_spec, "model" if ediv else None, None, None)),
                "hidden": _redistributor(mesh, (
                    dp_spec, "model" if ediv else None, None,
                    None if ediv else "model")),
                "out": _redistributor(mesh, (
                    dp_spec, "model" if ediv else None, None, None)),
            }

            def moe_hook(x, role):
                return moe_hooks[role](x)

    dtype = TRAIN_DTYPE if kind == "train" else SERVE_DTYPE
    params = meta_tree(fam.init, torch.Generator(), cfg, dtype, device="cpu")
    pspecs = shd.sanitize(shd.param_specs(cfg, params, fsdp=fsdp), params,
                          mesh)
    batch = input_specs(cfg, shape, dtype)
    bspecs = shd.sanitize(shd.batch_specs(cfg, axes, kind), batch, mesh)

    meta: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape_name,
        "mesh": "x".join(str(n) for n in axis_sizes(mesh).values()),
        "fsdp": fsdp, "kind": kind,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }

    dp_count = 32 if multi_pod else 16
    decode_shards = None
    if (kind == "decode" and cfg.arch_type not in ("ssm", "hybrid")
            and shape_name != "long_500k" and act_shard):
        decode_shards = (mesh, "model", dp_spec)

    def traced(step, *args):
        def run():
            with partitioned(), act_sharding.activation_sharding(
                    hook, moe_hook, moe_groups=dp_count,
                    decode_shards=decode_shards, remat_context=_Partitioner):
                return step(*args)
        return run

    if kind == "train":
        accum = accum_steps_for(cfg, shape, multi_pod)
        optimizer = "adafactor" if cfg.param_count() > 1e11 else "adamw"
        meta["accum_steps"] = accum
        meta["optimizer"] = optimizer
        step = make_train_step(cfg, accum_steps=accum, optimizer=optimizer)
        if optimizer == "adamw":
            opt = adamw_init(params)
            ospecs = shd.opt_state_specs(pspecs)
        else:
            opt = adafactor_init(params)
            ospecs = shd.adafactor_specs(pspecs)
        ospecs = shd.sanitize(ospecs, opt, mesh)
        args = (distribute_tree(params, pspecs, mesh),
                distribute_tree(opt, ospecs, mesh),
                distribute_tree(batch, bspecs, mesh))
        meta["arguments"] = args
        return traced(step, *args), meta
    if kind == "prefill":
        step = make_prefill_step(cfg)
        args = (distribute_tree(params, pspecs, mesh),
                distribute_tree(batch, bspecs, mesh))
        meta["arguments"] = args
        return traced(step, *args), meta
    ring = bool(shape_name == "long_500k"
                and cfg.arch_type not in ("ssm", "hybrid"))
    meta["ring"] = ring
    # fp8 KV cache (serving-standard quantization) when the bf16 cache
    # would crowd out the device: L*B*S*kv*hd*2(bytes)*2(k,v)/chips
    cache_gb = (cfg.n_layers * shape.global_batch * shape.seq_len
                * cfg.n_kv_heads * cfg.head_dim * 2 * 2) / 256
    cache_dtype = SERVE_DTYPE
    if cache_gb > 2 * 2**30 and cfg.arch_type not in ("ssm", "hybrid") \
            and not ring:
        cache_dtype = torch.float8_e4m3fn
        meta["kv_dtype"] = "float8_e4m3fn"
    cache = meta_tree(fam.init_decode_cache, cfg, shape.global_batch,
                      shape.seq_len, dtype=cache_dtype, ring=ring,
                      window=RING_WINDOW, device="cpu")
    cspecs = shd.sanitize(
        shd.cache_specs(cfg, axes, shape.global_batch, cache), cache, mesh)
    tok_spec = shd.token_spec(cfg, axes, shape.global_batch)
    token = distribute(torch.empty((shape.global_batch,), dtype=torch.int32,
                                   device="meta"), tok_spec, mesh)
    step = make_serve_step(cfg, ring=ring)
    args = (distribute_tree(params, pspecs, mesh),
            distribute_tree(cache, cspecs, mesh), token)
    meta["arguments"] = args
    return traced(step, *args), meta


# --------------------------------------------------------------------------
# Roofline extraction
# --------------------------------------------------------------------------

def analyze(run: Callable[[], Any], meta: Dict[str, Any]) -> Dict[str, Any]:
    """Trace the built step once under the cost counter; the JAX package's
    report keys where the meaning is the same (``hlo_flops`` and
    ``hlo_bytes`` are ``flops`` and ``bytes`` here; ``trace_seconds``
    takes the place of the compile-only keys)."""
    res = dict(meta)
    arguments = res.pop("arguments")
    t0 = time.time()
    out, counter = op_cost.measure(run)
    res["trace_seconds"] = time.time() - t0
    outs = [t for t in shd.leaves(out) if isinstance(t, torch.Tensor)]
    output = local_bytes(outs)
    # the arguments the step reads or hands back: XLA drops the others
    used = counter.reads | {
        op_cost.storage_key(getattr(t, "_local_tensor", t)) for t in outs}
    argument = local_bytes(arguments, used)
    res["bytes_per_device"] = {
        "argument": argument,
        "output": output,
        "temp": counter.peak,
        "peak": argument + counter.peak,
    }
    costs = counter.costs()
    res["flops"] = costs["flops"]
    res["bytes"] = costs["bytes"]
    res["collectives"] = costs["collectives"]
    res["per_partition"] = True
    return res


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             act_shard: bool = True) -> Dict[str, Any]:
    run, meta = build_step(arch, shape_name, multi_pod=multi_pod,
                           act_shard=act_shard)
    return analyze(run, meta)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--no-act-shard", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        todo = pairs()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        if (args.arch, args.shape) in SKIPS:
            print(f"SKIP {args.arch} x {args.shape}: "
                  f"{SKIPS[(args.arch, args.shape)]}")
            return
        todo = [(args.arch, args.shape)]

    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    results = []
    for arch, shape in todo:
        for mp in pods:
            tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            t0 = time.time()
            try:
                r = run_pair(arch, shape, mp, act_shard=not args.no_act_shard)
                r["ok"] = True
                peak = r["bytes_per_device"]["peak"]
                print(f"OK   {tag}: trace={r['trace_seconds']:.1f}s "
                      f"flops={r['flops']:.3e} bytes={r['bytes']:.3e} "
                      f"coll={r['collectives'].get('total', 0):.3e} "
                      f"peak/device={peak/2**30:.2f}GiB", flush=True)
            except Exception as e:
                r = {"arch": arch, "shape": shape, "ok": False,
                     "multi_pod": mp, "error": f"{type(e).__name__}: {e}"}
                print(f"FAIL {tag}: {r['error']}", flush=True)
            r["wall_seconds"] = time.time() - t0
            results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.out}")
    n_fail = sum(1 for r in results if not r.get("ok"))
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
