"""Transport types the coordinator names on every plane.

The process-isolated executor plane (worker processes behind a CRC-checked
TCP frame transport) is not ported yet.  What the coordinator and the data
engine need from it regardless of the plane lives here:

* :class:`WorkerDied` — the fault the coordinator's recovery path catches;
* :class:`StagedInput` — a keyed input value headed for a worker;
* :func:`encode_value` / :func:`decode_value` — the serialized datastore
  mode's codec (tensors pickle with their dtype, bits and device).
"""

from __future__ import annotations

import pickle
from typing import Any


class WorkerDied(RuntimeError):
    """A worker process left its fault domain: the process exited, its
    heartbeat went silent past the liveness deadline, or an RPC stalled
    past the wall cap.  Carries the executor id and the detection
    ``reason`` (``exit`` | ``heartbeat`` | ``stall`` | ``killed``)."""

    def __init__(self, executor_id: int, reason: str) -> None:
        super().__init__(f"worker {executor_id} died ({reason})")
        self.executor_id = executor_id
        self.reason = reason


class StagedInput(object):
    """A keyed input value headed for a worker: ship the payload if the
    worker has not staged ``key`` yet, else send the key alone."""

    __slots__ = ("key", "value")

    def __init__(self, key: str, value: Any) -> None:
        self.key = key
        self.value = value


def encode_value(value: Any) -> bytes:
    """Serialize one tensor/value for the datastore's serialized mode."""
    return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)


def decode_value(payload: bytes) -> Any:
    return pickle.loads(payload)
