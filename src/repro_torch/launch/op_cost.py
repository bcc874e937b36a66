"""Per-partition cost of one step, counted while it runs: the counterpart
of ``repro.launch.hlo_cost`` (and of ``repro.launch.dryrun``'s
``collective_bytes``).

The JAX package reads its costs from the post-SPMD HLO text of a compiled
step.  The port produces no HLO, so it counts the same quantities from
the aten operations a step issues: :class:`OpCost` is a
``TorchDispatchMode`` that sees every operation on the tensors of one
partition.  Under a ``DTensor`` trace on a fake-process-group mesh it
lets ``DTensor`` lower each operation first and then sees the local
operations on this rank's shards and the functional collectives
``DTensor`` issues, so every count is PER PARTITION, as the JAX package's
are.  The shape propagation ``DTensor`` runs under a ``FakeTensorMode``
is not counted.

* **FLOPs**: matrix products and convolutions only (the JAX package counts
  ``dot`` and ``convolution``), with ``torch.utils.flop_counter``'s
  formulas, plus the formulas the kernels' meta routes register
  (:mod:`repro_torch.kernels.meta`).  A Python loop over layers or
  microbatches issues its operations once per trip, so they count once
  per trip: what the JAX package's trip-count weighting of ``while``
  bodies recovers.
* **Bytes**: each non-view operation reads its tensor operands and writes
  its outputs once.  The JAX package counts this per XLA fusion of its
  CPU-compiled HLO, another granularity: every elementwise step of a
  fused chain counts here, while XLA's CPU fusions and layout copies
  count there, so the two totals differ in either direction.
* **Collectives**: output bytes by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``) and their
  ``total``.  The JAX package counts an async start/done pair once; the
  port counts each functional collective once.
* **Memory**: the bytes of the live tensors this partition's operations
  made, and their peak over the run (the arguments not included).
* **Reads**: the storages whose values some operation read (a view reads
  nothing, nor does an operation that takes only its input's shape), so
  that the dry run counts as arguments only the tensors a step reads, as
  XLA keeps only the arguments its program uses.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# functional-collective op names (and DTensor's own shard-to-shard
# all-to-all) -> the JAX package's kinds
_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("permute", "collective-permute"))
# bookkeeping ops of the functional collectives: no payload of their own
_NOT_PAYLOAD = ("wait_tensor", "wrap_tensor")
_NO_WRITE = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")
# operations that take only their inputs' shapes and dtypes
_NO_READ = _NO_WRITE + ("zeros_like", "ones_like", "full_like", "new_zeros",
                        "new_ones", "new_full")


def _nbytes(t: Any) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _collective_kind(name: str):
    if (("c10d" not in name and "_dtensor" not in name)
            or any(k in name for k in _NOT_PAYLOAD)):
        return None
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, which its views share."""
    return t.untyped_storage()._cdata


def _under_fake_mode(args: Any) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return True
    return any(isinstance(a, FakeTensor) for a in args)


class OpCost(TorchDispatchMode):
    """Counts the per-partition cost of the operations run under it."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self.reads: set = set()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and t.__name__ == "DTensor"
               for t in types):
            return NotImplemented       # let DTensor lower it to local ops
        out = func(*args, **kwargs)
        if _under_fake_mode(args):
            return out                  # DTensor's shape propagation
        packet = func._overloadpacket
        name = str(packet)
        if packet in self._formulas:
            self.flops += float(self._formulas[packet](*args, **kwargs,
                                                       out_val=out))
        kind = _collective_kind(name)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if kind is not None:
            b = sum(_nbytes(t) for t in outs)
            self.collectives[kind] = self.collectives.get(kind, 0.0) + b
        if func.is_view or any(k in name for k in _NOT_PAYLOAD):
            return out                  # aliases and bookkeeping: no bytes
        if not name.endswith(_NO_READ):
            self.reads.update(storage_key(t) for t in ins)
        if not name.endswith(_NO_WRITE):
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        for t in outs:                  # new tensors live until freed
            if not any(t is a for a in ins):
                n = _nbytes(t)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out

    def costs(self) -> Dict[str, Any]:
        """The JAX package's ``dynamic_costs`` dict."""
        coll = dict(self.collectives)
        coll["total"] = sum(coll.values())
        return {"flops": self.flops, "bytes": self.bytes, "collectives": coll}


def measure(fn: Callable, *args: Any, **kwargs: Any) -> Tuple[Any, OpCost]:
    """``fn(*args, **kwargs)`` under an :class:`OpCost`; returns the result
    and the counter."""
    counter = OpCost()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


def dynamic_costs(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, Any]:
    """Per-partition ``{"flops", "bytes", "collectives": {kind: bytes, ...,
    "total"}}`` of one call of ``fn`` (the JAX package's ``dynamic_costs``
    of the step's HLO)."""
    return measure(fn, *args, **kwargs)[1].costs()


def collective_bytes(fn: Callable, *args: Any, **kwargs: Any
                     ) -> Dict[str, float]:
    """Per-partition collective bytes by kind, and their ``total``."""
    return dynamic_costs(fn, *args, **kwargs)["collectives"]
