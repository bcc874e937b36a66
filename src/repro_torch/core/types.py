"""Typed values flowing through LegoDiffusion workflows.

The paper's DSL enforces strict input/output typing so that data
dependencies are explicit and composition errors surface at compile time
(§4.1).  This module defines:

* ``TensorType`` — a shape/dtype-annotated tensor type (the paper's
  ``torch.Tensor`` port type),
* ``Port`` — a declared model input/output (name, type, deferred flag),
* ``ValueRef`` — a symbolic reference to a value produced by a workflow node
  or a workflow input placeholder (what flows between model calls during
  tracing),
* ``DataRef`` — runtime metadata for a materialized tensor living in some
  executor's data store (the KiB-scale metadata the paper piggybacks on
  node-completion notifications, §4.3.2).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional, Tuple

import numpy as np


class WorkflowTypeError(TypeError):
    """Raised when workflow composition violates declared port typing."""


class Image:
    """Marker type for image inputs/outputs (decoded pixel space)."""


@dataclasses.dataclass(frozen=True)
class TensorType:
    """A tensor-valued port type.

    ``shape`` entries may be ``None`` (unconstrained dimension) or symbolic
    strings (e.g. ``"B"``) that must match consistently inside one model's
    signature.  ``dtype`` of ``None`` means any floating dtype.
    """

    shape: Optional[Tuple[Any, ...]] = None
    dtype: Optional[Any] = None

    def check(self, value: Any) -> bool:
        shape = getattr(value, "shape", None)
        if shape is None:
            return False
        if self.shape is not None:
            if len(shape) != len(self.shape):
                return False
            for want, got in zip(self.shape, shape):
                if isinstance(want, int) and want != got:
                    return False
        if self.dtype is not None:
            got_dtype = np.dtype(getattr(value, "dtype", None))
            if got_dtype != np.dtype(self.dtype):
                return False
        return True

    def compatible(self, other: "TensorType") -> bool:
        if self.shape is not None and other.shape is not None:
            if len(self.shape) != len(other.shape):
                return False
            for a, b in zip(self.shape, other.shape):
                if isinstance(a, int) and isinstance(b, int) and a != b:
                    return False
        if self.dtype is not None and other.dtype is not None:
            return np.dtype(self.dtype) == np.dtype(other.dtype)
        return True

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"TensorType(shape={self.shape}, dtype={self.dtype})"


# A port type is either a python type (int, str, Image, ...) or a TensorType.
PortType = Any


def type_name(t: PortType) -> str:
    if isinstance(t, TensorType):
        return repr(t)
    return getattr(t, "__name__", repr(t))


def check_value(t: PortType, value: Any) -> bool:
    """Does a concrete python value satisfy a declared port type?"""
    if isinstance(t, TensorType):
        return t.check(value)
    if t is float:
        return isinstance(value, (int, float))
    if isinstance(t, type):
        return isinstance(value, t)
    return True


def types_compatible(produced: PortType, consumed: PortType) -> bool:
    """Compile-time compatibility between a producer and a consumer port."""
    if isinstance(produced, TensorType) and isinstance(consumed, TensorType):
        return produced.compatible(consumed)
    if isinstance(produced, TensorType) or isinstance(consumed, TensorType):
        # tensor vs scalar: incompatible
        return False
    if produced is consumed:
        return True
    if isinstance(produced, type) and isinstance(consumed, type):
        return issubclass(produced, consumed) or issubclass(consumed, produced)
    return True


@dataclasses.dataclass(frozen=True)
class Port:
    name: str
    type: PortType
    deferred: bool = False


@dataclasses.dataclass(frozen=True)
class ValueRef:
    """Symbolic value produced during workflow tracing.

    ``producer`` is a node id (``int``) or ``None`` for workflow inputs.
    """

    name: str
    type: PortType
    producer: Optional[int] = None  # WorkflowNode id
    port: Optional[str] = None      # output port name on the producer
    is_input: bool = False          # workflow-level input placeholder

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        src = "input" if self.is_input else f"node{self.producer}.{self.port}"
        return f"ValueRef({self.name} <- {src})"


_dataref_counter = itertools.count()


@dataclasses.dataclass
class DataRef:
    """Runtime metadata of a materialized value.

    This is the paper's "tensor metadata, including a tensor's pointer"
    (§4.3.2): tiny, piggybacked on node-completion notifications, and used by
    the coordinator to track global tensor placement.
    """

    key: str
    nbytes: int
    executor_id: Optional[int]            # where the value lives
    producer_node: Optional[str] = None   # lineage for fault recovery
    refcount: int = 0                     # outstanding consumers (GC)

    @staticmethod
    def fresh_key(prefix: str = "t") -> str:
        return f"{prefix}{next(_dataref_counter)}"


def nbytes_of(value: Any) -> int:
    """Best-effort byte size of a runtime value."""
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    if isinstance(value, (bytes, bytearray, str)):
        return len(value)
    if isinstance(value, (list, tuple)):
        return sum(nbytes_of(v) for v in value)
    if isinstance(value, dict):
        return sum(nbytes_of(v) for v in value.values())
    return 8
