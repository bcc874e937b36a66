"""Wire transport for the process-isolated executor plane.

Executors promoted to real OS processes (:mod:`repro_torch.core.supervisor`)
talk to the coordinator over a localhost TCP socket carrying
**length-prefixed pickle frames with CRC32 checksums**:

.. code-block:: text

    +-------+----------------+----------------+=================+
    | MAGIC | payload length | CRC32(payload) |     payload     |
    | 4 B   | u32 big-endian | u32 big-endian | pickled message |
    +-------+----------------+----------------+=================+

Messages are plain dicts (``{"kind": ..., ...}``); tensor leaves are
converted to *portable* tensors before pickling: contiguous CPU tensors of
the same dtype and bits, whatever device they were on
(:func:`to_portable` / :func:`encode_value`).  So a value produced on one
process's card round-trips bit-exactly into another process, and a
process that decodes a frame or a datastore payload never opens a CUDA
context for it.  The checksum is verified on every frame — a corrupted
frame raises :class:`ChecksumError` instead of silently deserializing
garbage.

:class:`FrameChannel` is the coordinator-side endpoint for one worker.
Besides buffering/reassembly it implements the chaos plane's
*frame-level* faults (consulted on the receive path, where a real lossy
network would bite):

* **blackhole** — frames read during a wall-clock window are *held*, not
  destroyed (a partition queues traffic; TCP delivers it late).  Held
  frames do not refresh the liveness clock, so the heartbeat monitor
  declares the worker dead while its process is still running — the
  zombie whose late ``exec_done`` must then be epoch-fenced.
* **duplicate** — a control frame is delivered twice; the second copy
  must be rejected by the receiver's fencing (it is, by request id).
* **delay** — a control frame is held until after the *next* batch of
  frames, reordering it relative to later traffic.

Heartbeat frames are subject to blackholes (that is the point) but never
to duplicate/delay chaos — they carry no state to fence.
"""

from __future__ import annotations

import io
import pickle
import select
import struct
import time as _time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

MAGIC = b"LDTP"
_HEADER = struct.Struct(">4sII")   # magic | payload length | crc32
HEADER_BYTES = _HEADER.size

# frame kinds that carry protocol state (fenced / chaos-eligible);
# everything else ("hb", "hello") is liveness-only
CONTROL_KINDS = ("exec", "exec_done", "exec_err", "need", "stage",
                 "shutdown")


class TransportError(RuntimeError):
    """Malformed traffic on a worker channel."""


class ChecksumError(TransportError):
    """Frame payload failed its CRC32 — corrupted in flight."""


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


# --------------------------------------------------------------- tensors
def to_portable(obj: Any) -> Any:
    """Recursively convert tensor leaves to portable tensors: contiguous
    CPU tensors of the same dtype and bits (bf16, ``float8_e4m3fn`` and
    int8 included), whatever device they were on.  Dicts, lists and tuples
    keep their shape; numpy arrays and every other leaf stay as they
    are."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu").contiguous()
    if isinstance(obj, dict):
        return {k: to_portable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [to_portable(v) for v in obj]
        return tuple(out) if isinstance(obj, tuple) else out
    return obj


def _rebuild_tensor(raw: bytes, dtype: str, shape: Tuple[int, ...]
                    ) -> torch.Tensor:
    dt = getattr(torch, dtype)
    if not raw:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(
        dt).reshape(shape)


class _Pickler(pickle.Pickler):
    """Pickles a tensor as its elements' raw bytes, its dtype and shape.
    torch's own tensor pickling writes the whole storage a view looks
    into, and cannot read back a ``float8_e4m3fn`` tensor."""

    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            t = obj.detach().to("cpu").contiguous()
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
            return _rebuild_tensor, (raw, str(t.dtype).split(".")[-1],
                                     tuple(t.shape))
        return NotImplemented


def _dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def encode_value(value: Any) -> bytes:
    """Serialize one tensor/value for the wire or the datastore."""
    return _dumps(to_portable(value))


def decode_value(payload: bytes) -> Any:
    return pickle.loads(payload)


# ---------------------------------------------------------------- frames
def encode_frame(msg: Dict[str, Any]) -> bytes:
    payload = _dumps(to_portable(msg))
    return _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


def split_frames(buf: bytearray) -> List[Dict[str, Any]]:
    """Consume every complete frame from ``buf`` (in place); returns the
    decoded messages.  Raises on bad magic or checksum mismatch."""
    msgs: List[Dict[str, Any]] = []
    while len(buf) >= HEADER_BYTES:
        magic, length, crc = _HEADER.unpack_from(buf, 0)
        if magic != MAGIC:
            raise TransportError(f"bad frame magic {magic!r}")
        if len(buf) < HEADER_BYTES + length:
            break
        payload = bytes(buf[HEADER_BYTES:HEADER_BYTES + length])
        del buf[:HEADER_BYTES + length]
        if zlib.crc32(payload) != crc:
            raise ChecksumError(
                f"frame checksum mismatch ({length} byte payload)")
        msgs.append(pickle.loads(payload))
    return msgs


def read_frames_blocking(sock: Any, buf: bytearray) -> List[Dict[str, Any]]:
    """Worker-side receive: block until at least one full frame is in."""
    while True:
        msgs = split_frames(buf)
        if msgs:
            return msgs
        chunk = sock.recv(1 << 16)
        if not chunk:
            raise EOFError("peer closed")
        buf.extend(chunk)


# --------------------------------------------------------------- channel
class FrameChannel:
    """Coordinator-side endpoint of one worker's duplex socket.

    Tracks the liveness clock (``last_rx``: wall time of the last
    *accepted* frame — heartbeats included, blackholed traffic excluded)
    and applies the chaos plane's frame faults on receive.
    """

    def __init__(self, sock: Any, worker_id: int,
                 faults: Any = None) -> None:
        self.sock = sock
        self.worker_id = worker_id
        self.faults = faults
        self._rxbuf = bytearray()
        self.last_rx: float = _time.monotonic()
        self.eof = False
        # chaos state: wall deadline of the active blackhole window, the
        # frames it is holding, and delayed frames awaiting reorder
        self.blackhole_until: float = 0.0
        self._held_blackhole: List[Dict[str, Any]] = []
        self._held_delay: List[Dict[str, Any]] = []
        self._ctrl_rx = 0          # control-frame counter (chaos site)
        # accounting
        self.bytes_tx = 0
        self.bytes_rx = 0
        self.n_frames_rx = 0
        self.n_hb_rx = 0
        self.n_dup_frames = 0
        self.n_delayed_frames = 0
        self.n_crc_errors = 0
        # telemetry: when set (tracing on), accepted heartbeats append
        # their wall receive time here (bounded); the proc backend drains
        # it into worker-track instants during the liveness sweep
        self.hb_trace: Optional[List[float]] = None

    # ------------------------------------------------------------- send
    def send(self, msg: Dict[str, Any]) -> None:
        frame = encode_frame(msg)
        self.bytes_tx += len(frame)
        try:
            self.sock.sendall(frame)
        except OSError:
            self.eof = True

    # ---------------------------------------------------------- receive
    def poll(self, timeout: float = 0.0) -> List[Dict[str, Any]]:
        """Drain readable traffic (waiting up to ``timeout``), run it
        through the chaos pipeline, and return accepted *control*
        messages.  Heartbeats update ``last_rx`` and are filtered out."""
        raw = self._read_raw(timeout)
        now = _time.monotonic()
        fresh: List[Dict[str, Any]] = []
        # a healed blackhole delivers its queue late, ahead of new frames
        if self._held_blackhole and now >= self.blackhole_until:
            fresh.extend(self._held_blackhole)
            self._held_blackhole = []
        for msg in raw:
            if now < self.blackhole_until:
                self._held_blackhole.append(msg)
                continue
            fresh.append(msg)
        out: List[Dict[str, Any]] = []
        delayed_next: List[Dict[str, Any]] = []
        for msg in fresh:
            self.last_rx = now
            self.n_frames_rx += 1
            if msg.get("kind") == "hb":
                self.n_hb_rx += 1
                if self.hb_trace is not None and len(self.hb_trace) < 4096:
                    self.hb_trace.append(now)
                continue
            if msg.get("kind") == "hello":
                continue
            fault = None
            if self.faults is not None:
                self._ctrl_rx += 1
                fault = self.faults.frame_fault(self.worker_id, self._ctrl_rx)
            if fault == "dup":
                self.n_dup_frames += 1
                out.append(msg)
                out.append(msg)
            elif fault == "delay":
                self.n_delayed_frames += 1
                delayed_next.append(msg)
            else:
                out.append(msg)
        # frames delayed on a PREVIOUS poll arrive after this poll's
        # traffic: reordered relative to their original position
        out.extend(self._held_delay)
        self._held_delay = delayed_next
        return out

    def _read_raw(self, timeout: float) -> List[Dict[str, Any]]:
        if self.eof:
            return []
        try:
            readable, _, _ = select.select([self.sock], [], [], timeout)
        except (OSError, ValueError):
            self.eof = True
            return []
        if readable:
            try:
                chunk = self.sock.recv(1 << 20)
            except OSError:
                chunk = b""
            if not chunk:
                self.eof = True
            else:
                self.bytes_rx += len(chunk)
                self._rxbuf.extend(chunk)
        try:
            return split_frames(self._rxbuf)
        except ChecksumError:
            self.n_crc_errors += 1
            raise

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
        self.eof = True
