"""Device-slot management: the physical substrate of adaptive model
parallelism (§5.2), PyTorch port.

The scheduler picks a parallelism degree ``k`` per :class:`ScheduledBatch`.
The :class:`MeshManager` partitions a list of device *slots* into
per-executor slices (executor *i* owns slot ``i mod n_slots``, wrapping
when the fleet is larger than the list) and assembles **k-slot
submeshes** on demand, so a batch scheduled at parallelism ``k`` really
runs as one sharded forward over the k owning slots.

A slot is a ``torch.device`` object, and slots are told apart by identity,
as the JAX package tells its device objects apart: ``[torch.device("cuda",
0) for _ in range(4)]`` is four slots of one card, and ``[torch.device(
"cpu") for _ in range(4)]`` four slots of the host.  ``torch.device``
compares by value, so every key here is a slot's index, never its device.

The JAX package runs a submesh as one SPMD program (``shard_map``) whose
collectives are XLA's.  The port runs it as one process that drives the k
slots: a forward loops over the shards, and the collectives of
:class:`Submesh` (scatter, all-gather, gather, replicate) are plain
``Tensor.to`` and ``torch.cat``.  Launches are asynchronous and a copy
between cards does not wait for the host, so one host thread keeps k
cards busy; k slots of ONE card run their shards one after another.

Both sharding modes of the executable plane use the one axis:

* **data/CFG-branch parallel**: batch rows split across the slots (with
  CFG folded onto the batch axis, k = 2 puts the conditional and the
  unconditional branch on different slots);
* **sequence parallel**: image tokens split across the slots, with a
  per-layer K/V all-gather (see ``mmdit_apply_seq_sharded``).

``REPRO_SHARDED_EXEC=0`` disables sharded execution globally, and a
one-slot manager never shards.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.weights import to_device


def sharded_exec_enabled() -> bool:
    """Global gate for multi-slot execution (``REPRO_SHARDED_EXEC``)."""
    return os.environ.get("REPRO_SHARDED_EXEC", "1").lower() not in (
        "0", "false", "off")


class Submesh:
    """k slots of a :class:`MeshManager`, the lead executor's slot first,
    with the collectives a sharded forward needs.  ``slots`` are the slots'
    indices in the manager (the placement key); ``devices`` the slots
    themselves.  The first slot is the submesh's home: gathers land there.

    None of the collectives synchronises the host: each is ``Tensor.to``
    (which returns the tensor itself when it already lies on the slot's
    device, so a replica of a tree on its own card aliases it) and
    ``torch.cat`` (which always copies)."""

    def __init__(self, devices: Sequence[torch.device], slots: Sequence[int],
                 axis: str = "exec") -> None:
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        self.slots: Tuple[int, ...] = tuple(slots)
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def replicate(self, tree: Any) -> List[Any]:
        """``tree`` on every slot: one tree per slot, its tensors on the
        slot's device (aliased where they already lie there) and its
        device leaves naming it."""
        return [to_device(tree, d) for d in self.devices]

    def scatter(self, x: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """``x`` split into k equal parts along ``dim``, part i on slot i
        (views of ``x`` where the slot's device is its own)."""
        if x.shape[dim] % self.size:
            raise ValueError(f"scatter: dim {dim} of {tuple(x.shape)} does "
                             f"not split into {self.size} parts")
        return [p.to(d) for p, d in
                zip(torch.chunk(x, self.size, dim=dim), self.devices)]

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
        """Every slot's part, concatenated along ``dim``, on every slot
        (the JAX package's tiled ``all_gather``)."""
        return [torch.cat([p.to(d) for p in parts], dim=dim)
                for d in self.devices]

    def gather(self, parts: Sequence[torch.Tensor],
               dim: int = 0) -> torch.Tensor:
        """Every slot's part, concatenated along ``dim``, on the home
        slot."""
        return torch.cat([p.to(self.home) for p in parts], dim=dim)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<Submesh slots={self.slots} axis={self.axis!r}>"


class MeshManager:
    """Partitions device slots into per-executor slices and builds k-slot
    submeshes for scheduled batches.

    ``devices`` defaults to one slot per CUDA card (``torch.device("cuda",
    i)``) and raises where there is none: pass ``devices`` to run on the
    CPU, e.g. ``[torch.device("cpu") for _ in range(4)]``.  The
    assignment and clamping logic takes any list of objects; only
    :meth:`submesh`'s collectives need ``torch.device`` slots."""

    def __init__(self, devices: Optional[Sequence[Any]] = None,
                 axis: str = "exec") -> None:
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MeshManager(): no CUDA device is available; pass "
                    "devices=[torch.device('cpu'), ...] to run on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("MeshManager needs at least one device")
        self.devices: List[Any] = list(devices)
        self.axis = axis
        self._submeshes: Dict[Tuple[int, ...], Submesh] = {}

    # ------------------------------------------------------------ assignment
    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def device_of(self, executor_id: int) -> Any:
        """The slot owned by an executor (wraps when the fleet is larger
        than the slot list: those executors timeshare a slot)."""
        return self.devices[executor_id % len(self.devices)]

    def _slot_of(self, device: Any) -> int:
        return next(i for i, d in enumerate(self.devices) if d is device)

    def devices_of(self, executor_ids: Sequence[int]) -> List[Any]:
        """Ordered distinct slots backing ``executor_ids`` (the first
        executor's slot leads, matching the batch's lead executor)."""
        out: List[Any] = []
        seen = set()
        for eid in executor_ids:
            d = self.device_of(eid)
            if id(d) not in seen:
                seen.add(id(d))
                out.append(d)
        return out

    # -------------------------------------------------------------- clamping
    def max_k(self) -> int:
        """Fleet-wide ceiling: the largest submesh ANY executor set can
        form (1 when sharded execution is globally disabled)."""
        if not sharded_exec_enabled():
            return 1
        return len({id(d) for d in self.devices})

    def assemblable(self, executor_ids: Sequence[int]) -> int:
        """Largest submesh size buildable from these executors: the number
        of distinct slots they own."""
        return len(self.devices_of(executor_ids))

    def clamp(self, k: int, executor_ids: Sequence[int]) -> int:
        """Clamp a chosen parallelism degree to what can be materialized."""
        if not sharded_exec_enabled():
            return 1
        return max(1, min(k, self.assemblable(executor_ids)))

    # -------------------------------------------------------------- submesh
    def submesh(self, executor_ids: Sequence[int]) -> Submesh:
        """The :class:`Submesh` over the executors' distinct slots (cached
        per slot tuple)."""
        devs = self.devices_of(executor_ids)
        key = tuple(self._slot_of(d) for d in devs)
        if key not in self._submeshes:
            self._submeshes[key] = Submesh(devs, key, self.axis)
        return self._submeshes[key]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<MeshManager {len(self.devices)} slots axis={self.axis!r}>"
