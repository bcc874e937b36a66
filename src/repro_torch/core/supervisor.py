"""Process-isolated executor plane: worker processes + supervisor.

Promotes executors from in-process objects to **real OS processes** so
the fault domains the chaos plane injects into are honest: a worker can
be SIGKILLed, partitioned, or return stale results *independently of the
control plane*.  Three pieces live here:

* :func:`_worker_main` — the worker process.  Connects back to the
  coordinator over TCP (:mod:`repro_torch.core.transport` frames), starts
  a wall-clock heartbeat thread, and serves ``exec`` RPCs with its own
  :class:`~repro_torch.core.executor.LocalBackend` on the backend's device
  (on the card, each worker owns a CUDA context; components are
  per-process: a restarted worker is cold, exactly like the virtual
  warm-pool lifecycle assumes).  Keyed tensors are held in a bounded
  per-worker LRU **staging store** so chunked segments and re-dispatches
  to the same worker do not re-ship payloads; a missing key triggers the
  ``need``/``stage`` re-ship protocol instead of an error.  The worker's
  outputs stay in its store on its device; only the wire sees CPU
  tensors.
* :class:`Supervisor` — spawns (``multiprocessing`` *spawn* context: CUDA
  does not survive a fork, and the parent may hold a context), kills, and
  respawns workers, and owns the listening socket.
* :class:`ProcBackend` — drop-in :class:`LocalBackend` replacement the
  coordinator drives.  Each ``execute_batch`` is a synchronous RPC to
  the lead executor's worker; the measured duration that feeds the
  virtual timeline is the full RPC wall time (serialization + transport
  + worker compute), with the overhead split recorded honestly
  (``ser_seconds`` / ``transport_seconds`` / ``worker_seconds``).

**Weights across the boundary.**  An op built with given ``weights``
(``TextEncoder``, ``DiffusionBackbone``, ``ControlNet``, ``VAEDecode``,
``VAEEncode``, ``LoRAAdapter``, and a ``DenoiseSegment`` through its
backbone and branches) would pickle its tensors into every ``exec``
frame.  The backend withholds them from the frame instead: they ride the
staging protocol under a synthetic ``weights:<model_id>`` key, once per
worker incarnation, as the decoded adapter factors do under
``adapter:<model_id>``, and the worker hands them back to the ops before
it loads them.  Ops without given weights ship nothing: each worker draws
them on its own device from the model id's generator, bit for bit the
in-process backend's draw on the same device.

**Liveness and fencing.**  The parent declares a worker dead when its
process exits OR when no frame (heartbeats included) has been accepted
for ``hb_timeout`` wall seconds — a *lease*.  Every declared death bumps
the worker's **epoch** before any recovery: a partitioned zombie is
*adopted* (process and channel kept so its late traffic surfaces), and
any ``exec_done`` carrying an old epoch or request id is provably
rejected (``n_fenced``) instead of double-applying a batch.  This
extends the coordinator's dispatch-epoch guard across the process
boundary.  Dead processes are respawned through the warm-pool path with
the measured restart wall seconds charged to the executor's revive
delay.  A respawned worker builds no kernel: the libraries sit in
``build/`` under digest names (``repro_torch.kernels.build``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import time as _time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.executor import LocalBackend
from repro_torch.core.model import Model
from repro_torch.core.transport import (
    ChecksumError,
    FrameChannel,
    StagedInput,
    TransportError,
    WorkerDied,
    encode_frame,
    encode_value,
    decode_value,
    read_frames_blocking,
)

__all__ = [
    "ProcConfig",
    "ProcBackend",
    "Supervisor",
    "WorkerDied",
    "processes_available",
]


@dataclasses.dataclass(frozen=True)
class ProcConfig:
    """Knobs of the process plane (wall-clock, not virtual time)."""

    hb_interval: float = 0.05     # worker heartbeat period (s)
    hb_timeout: float = 3.0       # liveness lease: silence -> declared dead
    poll_interval: float = 0.01   # parent receive-poll granularity (s)
    exec_wall_timeout: float = 120.0  # hard cap on one RPC (stall guard)
    spawn_timeout: float = 120.0  # worker connect-back deadline (s)
    staging_entries: int = 512    # worker-side staging LRU capacity

    _INT_KEYS = ("staging_entries",)

    @classmethod
    def from_env(cls, env: Optional[str] = None) -> "ProcConfig":
        """``REPRO_PROC`` grammar: comma-separated ``key=value`` pairs
        over the dataclass fields, e.g.
        ``REPRO_PROC="hb_interval=0.02,hb_timeout=1.0"``.  Unknown keys
        raise ``ValueError`` naming the key."""
        spec = os.environ.get("REPRO_PROC", "") if env is None else env
        spec = spec.strip()
        known = {f.name for f in dataclasses.fields(cls)}
        kw: Dict[str, Any] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"REPRO_PROC: bad item {part!r}")
            k, v = part.split("=", 1)
            k = k.strip()
            if k not in known:
                raise ValueError(
                    f"REPRO_PROC: unknown key {k!r} "
                    f"(known: {', '.join(sorted(known))})")
            kw[k] = int(v) if k in cls._INT_KEYS else float(v)
        return cls(**kw)


# ------------------------------------------------------------------ probe
_available: Optional[bool] = None


def _probe_main() -> None:    # pragma: no cover - runs in the child
    os._exit(0)


def processes_available(timeout: float = 30.0) -> bool:
    """Can this host actually spawn worker processes?  Hosts that forbid
    fork/spawn make the probe fail; process tests skip cleanly instead of
    erroring.  Cached per interpreter."""
    global _available
    if _available is not None:
        return _available
    try:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        p = ctx.Process(target=_probe_main, daemon=True)
        p.start()
        p.join(timeout)
        ok = p.exitcode == 0
        if p.is_alive():
            p.kill()
            ok = False
        _available = ok
    except (OSError, ValueError, RuntimeError):
        _available = False
    return _available


# ---------------------------------------------------------------- weights
def _models(*roots: Any) -> Iterator[Model]:
    """Every :class:`Model` reachable from ``roots`` through model
    attributes, lists and tuples (a segment's backbone and branches, a
    model's patches, a request's ``_patches``), each once."""
    seen = set()
    stack = list(roots)
    while stack:
        obj = stack.pop()
        if isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif isinstance(obj, Model) and id(obj) not in seen:
            seen.add(id(obj))
            yield obj
            stack.extend(v for v in vars(obj).values()
                         if isinstance(v, (Model, list, tuple)))


def _given_weights(*roots: Any) -> Dict[str, List[Model]]:
    """The models reachable from ``roots`` that carry given ``weights``,
    by model id (the backend caches components per model id, so the
    first model of an id decides its weights, as in-process)."""
    out: Dict[str, List[Model]] = {}
    for m in _models(*roots):
        if getattr(m, "weights", None) is not None:
            out.setdefault(m.model_id, []).append(m)
    return out


@contextlib.contextmanager
def _weights_withheld(models: Sequence[Model]) -> Iterator[None]:
    """The models' ``weights`` set to None while a frame is encoded: the
    tensors travel through the staging protocol, not in the op."""
    held = [(m, m.weights) for m in models]
    try:
        for m, _ in held:
            m.weights = None
        yield
    finally:
        for m, w in held:
            m.weights = w


# ----------------------------------------------------------------- worker
def _stage_put(staging: "OrderedDict[str, Any]", key: str, value: Any,
               cap: int) -> None:
    staging[key] = value
    staging.move_to_end(key)
    while len(staging) > cap:
        staging.popitem(last=False)


def _worker_main(host: str, port: int, worker_id: int, hb_interval: float,
                 staging_cap: int, device: str, n_threads: int) -> None:
    """Worker process entry point (spawn target — must be importable).

    Runs ``LocalBackend(device)`` with the parent's ``n_threads`` intra-op
    threads: a CPU GEMM's bits can depend on its thread count, so the
    worker computes what the in-process backend would.  On the card the
    worker opens its CUDA context before it says hello, so the spawn wall
    covers it, and a card that is not there fails the spawn."""
    import threading

    torch.set_num_threads(n_threads)
    backend = LocalBackend(device=device)
    if backend.device.type == "cuda":
        torch.zeros((), device=backend.device)
        torch.cuda.synchronize(backend.device)
    sock = socket.create_connection((host, port))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    wlock = threading.Lock()

    def send(msg: Dict[str, Any]) -> None:
        frame = encode_frame(msg)
        with wlock:
            sock.sendall(frame)

    send({"kind": "hello", "worker": worker_id, "pid": os.getpid()})
    stop = threading.Event()

    def _beat() -> None:
        while not stop.wait(hb_interval):
            try:
                send({"kind": "hb", "worker": worker_id})
            except OSError:
                return

    threading.Thread(target=_beat, daemon=True).start()

    staging: "OrderedDict[str, Any]" = OrderedDict()
    buf = bytearray()
    pending: List[Dict[str, Any]] = []

    def next_msg() -> Dict[str, Any]:
        while not pending:
            pending.extend(read_frames_blocking(sock, buf))
        return pending.pop(0)

    def stage_values(values: Dict[str, bytes]) -> None:
        for key, payload in values.items():
            _stage_put(staging, key, decode_value(payload), staging_cap)

    try:
        while True:
            msg = next_msg()
            kind = msg.get("kind")
            if kind == "shutdown":
                break
            if kind == "stage":
                stage_values(msg.get("values", {}))
                continue
            if kind != "exec":
                continue
            # span recording is driven by the exec message's trace flag
            # (parent-side REPRO_TELEMETRY decision), with timestamps
            # relative to RPC receipt — the parent rebases them onto the
            # virtual dispatch time when the reply lands
            trace = bool(msg.get("trace"))
            t_rpc = _time.perf_counter() if trace else 0.0
            spans: List[Dict[str, Any]] = []
            try:
                op = msg["op"]
                patches = list(msg.get("patches") or ())
                entries = msg["batch"]
                t_stage0 = _time.perf_counter() if trace else 0.0
                # stage shipped payloads, then ask for anything referenced
                # but locally evicted (LRU) or lost to a restart
                need = set()
                for entry in entries:
                    for spec in entry.values():
                        if spec[0] == "ship":
                            _stage_put(staging, spec[1],
                                       decode_value(spec[2]), staging_cap)
                        elif spec[0] == "ref" and spec[1] not in staging:
                            need.add(spec[1])
                # given weights of the op's models: shipped once per worker
                # incarnation, referenced by key afterwards
                weights = msg.get("weights") or {}
                for spec in weights.values():
                    if spec[0] == "ship":
                        _stage_put(staging, spec[1], decode_value(spec[2]),
                                   staging_cap)
                    elif spec[1] not in staging:
                        need.add(spec[1])
                # decoded multi-LoRA factors: seed the adapter pool from
                # shipped payloads; bare refs missing from both the pool
                # and the staging store go through the need protocol
                adapters = msg.get("adapters") or {}
                for pid, spec in adapters.items():
                    if spec[0] == "ship":
                        comps = decode_value(spec[2])
                        _stage_put(staging, spec[1], comps, staging_cap)
                        backend.adapter_pool.seed(pid, comps)
                    elif pid not in backend.adapter_pool:
                        if spec[1] in staging:
                            backend.adapter_pool.seed(pid, staging[spec[1]])
                        else:
                            need.add(spec[1])
                if need:
                    send({"kind": "need", "req": msg["req"],
                          "worker": worker_id, "keys": sorted(need)})
                    while need - set(staging):
                        m2 = next_msg()
                        if m2.get("kind") == "stage":
                            stage_values(m2.get("values", {}))
                        elif m2.get("kind") == "shutdown":
                            return
                    for pid, spec in adapters.items():
                        if spec[0] == "ref" and pid not in backend.adapter_pool:
                            backend.adapter_pool.seed(pid, staging[spec[1]])
                if trace:
                    spans.append({
                        "name": "stage", "cat": "stage",
                        "t0": t_stage0 - t_rpc,
                        "dur": _time.perf_counter() - t_stage0,
                        "args": {"needed": len(need)}})
                kws: List[Dict[str, Any]] = []
                for entry in entries:
                    kw: Dict[str, Any] = {}
                    for name, spec in entry.items():
                        if spec[0] == "val":
                            kw[name] = spec[1]
                        else:           # "ship" already staged; "ref" too
                            kw[name] = staging[spec[1]]
                    kws.append(kw)
                if weights:
                    given = {mid: staging[spec[1]]
                             for mid, spec in weights.items()}
                    for m in _models(op, patches,
                                     [kw.get("_patches") for kw in kws]):
                        if m.model_id in given:
                            m.weights = given[m.model_id]
                n0 = len(backend.forward_log)
                t_fwd0 = _time.perf_counter() if trace else 0.0
                outs, load_dt, exec_dt = backend.execute_batch(
                    op, kws, patches=patches)
                if trace:
                    spans.append({
                        "name": f"forward {getattr(op, 'model_id', '?')}",
                        "cat": "forward", "t0": t_fwd0 - t_rpc,
                        "dur": _time.perf_counter() - t_fwd0,
                        "args": {"batch": len(entries), "load_dt": load_dt,
                                 "exec_dt": exec_dt}})
                for okeys, out in zip(msg.get("out_keys") or (), outs):
                    if isinstance(out, dict):
                        for port, key in okeys.items():
                            if port in out:
                                _stage_put(staging, key, out[port],
                                           staging_cap)
                reply = {"kind": "exec_done", "req": msg["req"],
                         "epoch": msg["epoch"], "worker": worker_id,
                         "outs": outs, "load_dt": load_dt,
                         "exec_dt": exec_dt,
                         # forward_log is a bounded deque: materialize
                         # before slicing off this RPC's entries
                         "forwards": list(backend.forward_log)[n0:]}
                if trace:
                    reply["spans"] = spans
                send(reply)
            except Exception as exc:   # surfaced parent-side, not fatal here
                send({"kind": "exec_err", "req": msg["req"],
                      "epoch": msg["epoch"], "worker": worker_id,
                      "error": f"{type(exc).__name__}: {exc}",
                      "load_dt": 0.0, "exec_dt": 0.0})
    except (EOFError, OSError):
        pass      # parent went away: nothing to report to
    finally:
        stop.set()
        try:
            sock.close()
        except OSError:
            pass


# ------------------------------------------------------------- supervisor
class WorkerHandle:
    """Parent-side state of one worker process."""

    __slots__ = ("executor_id", "proc", "channel", "epoch", "pid",
                 "n_spawns", "spawn_seconds")

    def __init__(self, executor_id: int) -> None:
        self.executor_id = executor_id
        self.proc: Any = None
        self.channel: Optional[FrameChannel] = None
        self.epoch = 0          # bumped on every declared death (fencing)
        self.pid: Optional[int] = None
        self.n_spawns = 0
        # wall seconds of each spawn, start to hello (process start, torch
        # import and, on the card, the CUDA context)
        self.spawn_seconds: List[float] = []


class Supervisor:
    """Spawns, kills, and respawns worker processes; owns the listener.

    Each worker runs its ``LocalBackend`` on ``device`` with the parent's
    intra-op thread count at the time of the spawn."""

    def __init__(self, config: ProcConfig, faults: Any = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.config = config
        self.faults = faults
        self.device = str(device)
        self.workers: Dict[int, WorkerHandle] = {}
        self._listener: Optional[socket.socket] = None
        self.n_spawns = 0
        self.n_kills = 0
        # byte counters of channels already torn down (respawn/shutdown)
        self.retired_tx = 0
        self.retired_rx = 0

    def _ensure_listener(self) -> socket.socket:
        if self._listener is None:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            s.listen(16)
            self._listener = s
        return self._listener

    def _accept(self, h: WorkerHandle) -> socket.socket:
        """The new worker's connection, or TransportError as soon as its
        process exits (an import or device failure) or ``spawn_timeout``
        passes."""
        listener = self._listener
        deadline = _time.monotonic() + self.config.spawn_timeout
        listener.settimeout(0.05)
        while True:
            try:
                conn, _ = listener.accept()
                return conn
            except socket.timeout:
                pass
            if not h.proc.is_alive():
                raise TransportError(
                    f"worker {h.executor_id} exited with code "
                    f"{h.proc.exitcode} before connecting back")
            if _time.monotonic() > deadline:
                h.proc.kill()
                h.proc.join(1.0)
                raise TransportError(
                    f"worker {h.executor_id} never connected back "
                    f"(spawn_timeout={self.config.spawn_timeout}s)")

    def spawn(self, executor_id: int) -> WorkerHandle:
        """Start (or restart) the worker for ``executor_id`` and wait for
        its hello frame.  The handle's epoch survives restarts — stale
        frames from the previous incarnation stay fenced."""
        import multiprocessing as mp

        listener = self._ensure_listener()
        host, port = listener.getsockname()
        h = self.workers.setdefault(executor_id, WorkerHandle(executor_id))
        self._teardown_channel(h)
        ctx = mp.get_context("spawn")
        t0 = _time.perf_counter()
        proc = ctx.Process(
            target=_worker_main,
            args=(host, port, executor_id, self.config.hb_interval,
                  self.config.staging_entries, self.device,
                  torch.get_num_threads()),
            daemon=True,
        )
        proc.start()
        h.proc = proc
        conn = self._accept(h)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(self.config.spawn_timeout)
        buf = bytearray()
        pid = None
        try:
            while pid is None:
                for msg in read_frames_blocking(conn, buf):
                    if msg.get("kind") == "hello":
                        pid = msg.get("pid")
        except (OSError, EOFError) as exc:
            conn.close()
            raise TransportError(
                f"worker {executor_id} sent no hello: {exc}") from exc
        conn.settimeout(None)
        h.channel = FrameChannel(conn, executor_id, self.faults)
        # frames that arrived behind the hello (heartbeats) stay buffered
        h.channel._rxbuf.extend(buf)
        h.pid = pid
        h.n_spawns += 1
        h.spawn_seconds.append(_time.perf_counter() - t0)
        self.n_spawns += 1
        return h

    def _teardown_channel(self, h: WorkerHandle) -> None:
        if h.channel is not None:
            self.retired_tx += h.channel.bytes_tx
            self.retired_rx += h.channel.bytes_rx
            h.channel.close()
            h.channel = None

    def kill(self, executor_id: int) -> None:
        """SIGKILL the worker process (chaos plane / control-plane
        initiated failure).  The channel stays open: undelivered frames
        vanish with the socket — exactly what a hard kill does."""
        h = self.workers.get(executor_id)
        if h is not None and h.proc is not None and h.proc.is_alive():
            h.proc.kill()
            self.n_kills += 1

    def shutdown(self) -> None:
        for h in self.workers.values():
            if h.channel is not None and not h.channel.eof:
                try:
                    h.channel.send({"kind": "shutdown"})
                except OSError:
                    pass
        for h in self.workers.values():
            if h.proc is not None:
                h.proc.join(1.0)
                if h.proc.is_alive():
                    h.proc.kill()
                    h.proc.join(0.5)
            self._teardown_channel(h)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None


# ---------------------------------------------------------------- backend
class ProcBackend(LocalBackend):
    """Executable backend whose executors are separate OS processes.

    Keeps the :class:`LocalBackend` surface (``forward_log``,
    ``exec_seconds``, transient-fault injection hook) so the coordinator
    and the tests read one vocabulary, but every ``execute_batch`` is a
    framed RPC to the lead executor's worker process.

    ``device`` is every worker's device (``"cuda"`` unless the caller
    asks for the CPU, as the tests do).  A CUDA device with no card
    available raises here, before any process is spawned.  The parent
    draws on the same device the adapter factors it ships, so a tenant's
    image equals the in-process backend's.
    """

    is_proc_plane = True

    def __init__(self, config: Optional[ProcConfig] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(device=device)
        self.config = config or ProcConfig.from_env()
        self.supervisor = Supervisor(self.config, device=self.device)
        self.co: Any = None               # coordinator (attach_coordinator)
        self.engine: Any = None
        self._faults: Any = None
        self._req_seq = 0
        # accounting (honest overhead split + fencing/recovery counters)
        self.n_execs = 0
        self.exec_log: List[Tuple[str, int]] = []   # (model_id, executor)
        # per applied RPC: (model_id, executor, rpc wall, worker load
        # seconds, worker exec seconds)
        self.rpc_log: List[Tuple[str, int, float, float, float]] = []
        self.n_exec_replies = 0     # exec_done/exec_err frames accepted
        self.n_exec_applied = 0     # ... that matched epoch + request id
        self.n_fenced = 0           # ... provably rejected as stale
        self._crc_errors = 0
        self.ser_seconds = 0.0      # parent-side encode/decode wall
        self.transport_seconds = 0.0  # rpc wall - worker compute (+ ser)
        self.worker_seconds = 0.0   # worker-measured load+exec
        self.restart_seconds = 0.0  # measured respawn wall
        self.staging_hits = 0       # keyed inputs sent as a bare key
        self.staging_ships = 0      # keyed inputs shipped as payload
        self.bytes_shipped = 0      # serialized tensor bytes sent
        # multi-LoRA adapter shipping (decoded A/B factors ride the same
        # staging protocol under synthetic ``adapter:<model_id>`` keys)
        self.adapter_ships = 0      # adapter factor sets shipped as payload
        self.adapter_hits = 0       # ... sent as a bare staged ref
        # given weights (``weights:<model_id>`` keys), the same way
        self.weight_ships = 0       # weight trees shipped as payload
        self.weight_hits = 0        # ... sent as a bare staged ref
        # telemetry: span context of recent exec RPCs, kept (bounded) so
        # a FENCED zombie reply's worker spans can still be attributed to
        # the request trace that issued the RPC
        self._rpc_meta: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()

    # ------------------------------------------------------------- wiring
    def attach_coordinator(self, co: Any) -> None:
        """Called by the Coordinator at construction: bind the serialized
        datastore and the fault plane, and mark the plane as proc."""
        self.co = co
        self.engine = co.engine
        self.engine.serialized = True
        self._faults = co.faults
        self.supervisor.faults = co.faults

    # ------------------------------------------------------------ workers
    def ensure_worker(self, executor_id: int) -> WorkerHandle:
        h = self.workers.get(executor_id)
        if h is None or h.channel is None:
            h = self.supervisor.spawn(executor_id)
            self._note_spawn(executor_id, h)
        return h

    @property
    def workers(self) -> Dict[int, WorkerHandle]:
        return self.supervisor.workers

    def _note_spawn(self, executor_id: int, h: WorkerHandle) -> None:
        if self.co is not None:
            ex = self.co.by_id.get(executor_id)
            if ex is not None:
                ex.worker_pid = h.pid
                ex.epoch = h.epoch
            tr = self.co.tracer
            if tr.enabled and h.channel is not None:
                if h.channel.hb_trace is None:
                    h.channel.hb_trace = []
                tr.set_process_name(
                    h.pid, f"worker-{executor_id} (pid {h.pid})")

    def kill_worker(self, executor_id: int) -> None:
        self.supervisor.kill(executor_id)

    def recover_worker(self, executor_id: int) -> float:
        """Supervised recovery after a declared death.  Bumps the fencing
        epoch, clears the parent's view of the worker's staging, then
        either **adopts** a live-but-partitioned zombie (process and
        channel kept, so its late frames surface and get fenced; the
        liveness lease re-arms from now) or **respawns** a dead process.
        Returns the measured restart wall seconds (0 for adoption) — the
        coordinator charges it to the executor's revive delay."""
        h = self.workers.get(executor_id)
        if self.engine is not None:
            self.engine.unstage_executor(executor_id)
        if h is None:
            t0 = _time.perf_counter()
            h = self.supervisor.spawn(executor_id)
            dt = _time.perf_counter() - t0
        else:
            h.epoch += 1
            if (h.proc is not None and h.proc.is_alive()
                    and h.channel is not None and not h.channel.eof):
                h.channel.last_rx = _time.monotonic()   # lease renewed
                dt = 0.0
            else:
                t0 = _time.perf_counter()
                self.supervisor.spawn(executor_id)
                dt = _time.perf_counter() - t0
        self.restart_seconds += dt
        self._note_spawn(executor_id, h)
        return dt

    def poll_liveness(self) -> List[WorkerDied]:
        """Cheap idle-worker sweep the coordinator runs every event-loop
        iteration: drain each live worker's channel (stale replies found
        here are fenced — no RPC is waiting on them), then check the
        process and the heartbeat lease."""
        dead: List[WorkerDied] = []
        if self.co is None:
            return dead
        for eid, h in self.workers.items():
            ex = self.co.by_id.get(eid)
            if ex is None or not ex.alive or h.channel is None:
                continue
            try:
                msgs = h.channel.poll(0.0)
            except ChecksumError:
                self._crc_errors += 1
                msgs = []
            for m in msgs:
                if m.get("kind") in ("exec_done", "exec_err"):
                    self.n_exec_replies += 1
                    self.n_fenced += 1
                    self._note_fenced_reply(m)
            if h.channel.hb_trace:
                tr = self.co.tracer
                if tr.enabled and h.pid is not None:
                    for t in h.channel.hb_trace:
                        tr.instant("hb", self.co.now, h.pid, "hb",
                                   cat="hb", args={"wall": round(t, 6)})
                del h.channel.hb_trace[:]
            now = _time.monotonic()
            if h.channel.eof or h.proc is None or not h.proc.is_alive():
                dead.append(WorkerDied(eid, "exit"))
            elif now - h.channel.last_rx > self.config.hb_timeout:
                dead.append(WorkerDied(eid, "heartbeat"))
        return dead

    # ---------------------------------------------------------- execution
    def _stage_spec(self, executor_id: int, key: str, value: Any
                    ) -> Tuple[Tuple[Any, ...], float]:
        """``("ref", key)`` when the worker holds ``key``, else
        ``("ship", key, payload)``; and the encode seconds."""
        if (self.engine is not None
                and self.engine.is_staged(executor_id, key)):
            return ("ref", key), 0.0
        payload, dt = self._encode(key, value)
        self.bytes_shipped += len(payload)
        return ("ship", key, payload), dt

    def execute_batch(
        self,
        model: Any,
        batch_kwargs: List[Dict[str, Any]],
        patches: Sequence[Any] = (),
        executor_id: Optional[int] = None,
        out_keys: Optional[List[Dict[str, str]]] = None,
    ) -> Tuple[List[Dict[str, Any]], float, float]:
        if executor_id is None:
            # direct caller without a coordinator: run in-process
            clean = [{k: (v.value if isinstance(v, StagedInput) else v)
                      for k, v in kw.items()} for kw in batch_kwargs]
            return super().execute_batch(model, clean, patches)
        self._maybe_inject_fault()
        h = self.ensure_worker(executor_id)
        exec_index = self.n_execs
        self.n_execs += 1
        self.exec_log.append((model.model_id, executor_id))
        shippable: Dict[str, Any] = {}
        entries: List[Dict[str, Any]] = []
        ser = 0.0
        for kw in batch_kwargs:
            entry: Dict[str, Any] = {}
            for name, v in kw.items():
                if isinstance(v, StagedInput):
                    shippable[v.key] = v.value
                    entry[name], dt = self._stage_spec(executor_id, v.key,
                                                       v.value)
                    ser += dt
                    if entry[name][0] == "ref":
                        self.staging_hits += 1
                    else:
                        self.staging_ships += 1
                else:
                    entry[name] = ("val", v)
            entries.append(entry)
        okeys = list(out_keys or ())
        while len(okeys) < len(entries):
            okeys.append({})
        # grouped multi-LoRA: per-request ``_patches`` ride the batch
        # entries (tiny adapter Model objects), while the DECODED A/B
        # factors ship through the staging protocol under synthetic
        # ``adapter:<model_id>`` keys — a worker that already staged an
        # adapter gets a bare ref, a restarted worker re-ships only what
        # it is missing (the need protocol covers LRU evictions).  The
        # parent draws them on the workers' device.
        adapter_specs: Dict[str, Any] = {}
        for kw in batch_kwargs:
            for p in kw.get("_patches") or []:
                pid = p.model_id
                if pid in adapter_specs:
                    continue
                akey = f"adapter:{pid}"
                comps, _ = self.adapter_pool.get(p)
                shippable[akey] = comps
                adapter_specs[pid], dt = self._stage_spec(executor_id, akey,
                                                          comps)
                ser += dt
                if adapter_specs[pid][0] == "ref":
                    self.adapter_hits += 1
                else:
                    self.adapter_ships += 1
        # given weights of every model the op reaches: withheld from the
        # frame, staged under ``weights:<model_id>``
        given = _given_weights(model, list(patches or ()),
                               [kw.get("_patches") for kw in batch_kwargs])
        weight_specs: Dict[str, Any] = {}
        for mid, models in given.items():
            wkey = f"weights:{mid}"
            shippable[wkey] = models[0].weights
            weight_specs[mid], dt = self._stage_spec(executor_id, wkey,
                                                     models[0].weights)
            ser += dt
            if weight_specs[mid][0] == "ref":
                self.weight_hits += 1
            else:
                self.weight_ships += 1
        self._req_seq += 1
        msg = {"kind": "exec", "req": self._req_seq, "epoch": h.epoch,
               "op": model, "patches": list(patches or ()),
               "batch": entries, "out_keys": okeys}
        if adapter_specs:
            msg["adapters"] = adapter_specs
        if weight_specs:
            msg["weights"] = weight_specs
        ctx = self.trace_ctx
        if ctx is not None:
            # propagate span context across the frame transport: the
            # worker records stage/forward spans relative to RPC receipt;
            # we keep the dispatch's virtual timestamp so replies — live
            # OR fenced-late — rebase onto the request's trace
            msg["trace"] = True
            self._rpc_meta[self._req_seq] = {
                "ts": ctx["ts"], "rids": list(ctx["rids"]),
                "pid": h.pid, "eid": executor_id,
                "model": getattr(model, "model_id", "?")}
            while len(self._rpc_meta) > 256:
                self._rpc_meta.popitem(last=False)
        t0 = _time.perf_counter()
        with _weights_withheld([m for ms in given.values() for m in ms]):
            h.channel.send(msg)
        if self._faults is not None:
            # process-level chaos, injected at the real boundary: the
            # frame is already in the socket when the SIGKILL lands
            if self._faults.proc_kill(exec_index):
                self.supervisor.kill(executor_id)
            bh = self._faults.proc_blackhole(exec_index)
            if bh:
                h.channel.blackhole_until = _time.monotonic() + bh
        reply, ser2 = self._await_reply(h, self._req_seq, executor_id,
                                        shippable)
        rpc_wall = _time.perf_counter() - t0
        ser += ser2
        self.ser_seconds += ser
        if ctx is not None and reply.get("spans"):
            meta = self._rpc_meta.get(reply.get("req"))
            if meta is not None:
                self._record_worker_spans(reply["spans"], meta)
        if reply["kind"] == "exec_err":
            raise RuntimeError(
                f"worker {executor_id}: {reply.get('error')}")
        worker_dt = reply["load_dt"] + reply["exec_dt"]
        self.worker_seconds += worker_dt
        self.transport_seconds += max(0.0, rpc_wall - worker_dt)
        self.rpc_log.append((model.model_id, executor_id, rpc_wall,
                             reply["load_dt"], reply["exec_dt"]))
        self.forward_log.extend(tuple(f) for f in reply.get("forwards", ()))
        self.exec_seconds += rpc_wall
        if self.engine is not None:
            for key in shippable:
                self.engine.stage_mark(executor_id, key)
            for ok in okeys:
                for key in ok.values():
                    self.engine.stage_mark(executor_id, key)
        load_dt = reply["load_dt"]
        return reply["outs"], load_dt, max(0.0, rpc_wall - load_dt)

    def _encode(self, key: str, value: Any) -> Tuple[bytes, float]:
        """Serialize one keyed tensor, reusing the datastore's canonical
        payload when the key round-tripped through a serialized put."""
        t0 = _time.perf_counter()
        payload = None
        if self.engine is not None:
            payload = self.engine.payload_for(key)
        if payload is None:
            payload = encode_value(value)
        return payload, _time.perf_counter() - t0

    def _await_reply(
        self, h: WorkerHandle, req_id: int, executor_id: int,
        shippable: Dict[str, Any],
    ) -> Tuple[Dict[str, Any], float]:
        cfg = self.config
        deadline = _time.monotonic() + cfg.exec_wall_timeout
        ser = 0.0
        while True:
            try:
                msgs = h.channel.poll(cfg.poll_interval)
            except ChecksumError:
                self._crc_errors += 1
                continue
            for m in msgs:
                kind = m.get("kind")
                if kind == "need":
                    values: Dict[str, bytes] = {}
                    for key in m.get("keys", ()):
                        if key in shippable:
                            payload, dt = self._encode(key, shippable[key])
                            ser += dt
                            self.staging_ships += 1
                            self.bytes_shipped += len(payload)
                            values[key] = payload
                    h.channel.send({"kind": "stage", "values": values})
                elif kind in ("exec_done", "exec_err"):
                    self.n_exec_replies += 1
                    if m.get("epoch") != h.epoch or m.get("req") != req_id:
                        # zombie/duplicate traffic: stale lease, provably
                        # rejected — the cross-process dispatch-epoch guard
                        self.n_fenced += 1
                        self._note_fenced_reply(m)
                        continue
                    self.n_exec_applied += 1
                    return m, ser
            now = _time.monotonic()
            if h.channel.eof or h.proc is None or not h.proc.is_alive():
                raise WorkerDied(executor_id, "exit")
            if now - h.channel.last_rx > cfg.hb_timeout:
                raise WorkerDied(executor_id, "heartbeat")
            if now > deadline:
                self.supervisor.kill(executor_id)
                raise WorkerDied(executor_id, "stall")

    # ----------------------------------------------------------- telemetry
    def _record_worker_spans(self, spans: Sequence[Dict[str, Any]],
                             meta: Dict[str, Any],
                             fenced: bool = False) -> None:
        """Rebase worker-recorded spans (wall offsets relative to RPC
        receipt) onto the dispatch's virtual timestamp and emit them on
        the worker's process track.  Fenced zombie replies land on a
        dedicated ``fenced`` thread — their slices must not interleave
        with live work an adopted worker serves later — orphaned from the
        flow, but still attributed to the request trace that issued the
        RPC."""
        if self.co is None:
            return
        tr = self.co.tracer
        if not tr.enabled or not spans or meta.get("pid") is None:
            return
        pid = meta["pid"]
        tid = "fenced" if fenced else "worker"
        rids = meta.get("rids") or []
        trace = rids[0] if rids else None
        base = meta["ts"]
        first_ts: Optional[float] = None
        for s in spans:
            ts = base + max(0.0, float(s.get("t0", 0.0)))
            if first_ts is None:
                first_ts = ts
            args = dict(s.get("args") or {})
            args["executor"] = meta.get("eid")
            args["rids"] = list(rids)
            if fenced:
                args["fenced"] = True
            tr.span(s.get("name", "?"), ts, float(s.get("dur", 0.0)),
                    pid=pid, tid=tid,
                    cat="fenced" if fenced else (s.get("cat") or "worker"),
                    trace=trace, args=args)
        if first_ts is not None and not fenced:
            # flow steps stitch the request across the process boundary;
            # step=True so the root stays on the coordinator's dispatch
            # slice (recorded later, timestamped earlier)
            for rid in rids:
                tr.flow(rid, first_ts, pid, tid, step=True)

    def _note_fenced_reply(self, m: Dict[str, Any]) -> None:
        """A provably-stale reply was just fenced: surface it on the
        timeline, attributed to the request trace whose RPC produced it
        (span context retained in ``_rpc_meta``)."""
        if self.co is None or not self.co.tracer.enabled:
            return
        meta = self._rpc_meta.get(m.get("req"))
        if meta is None or meta.get("pid") is None:
            return
        tr = self.co.tracer
        rids = meta.get("rids") or []
        tr.instant("fenced_reply", self.co.now, meta["pid"], "fenced",
                   cat="fenced", trace=rids[0] if rids else None,
                   args={"executor": meta.get("eid"),
                         "model": meta.get("model"),
                         "kind": m.get("kind"), "rids": list(rids)})
        if m.get("spans"):
            self._record_worker_spans(m["spans"], meta, fenced=True)

    # ---------------------------------------------------------- accounting
    @property
    def crc_errors(self) -> int:
        return self._crc_errors + sum(
            h.channel.n_crc_errors for h in self.workers.values()
            if h.channel is not None)

    @property
    def bytes_tx(self) -> int:
        return self.supervisor.retired_tx + sum(
            h.channel.bytes_tx for h in self.workers.values()
            if h.channel is not None)

    @property
    def bytes_rx(self) -> int:
        return self.supervisor.retired_rx + sum(
            h.channel.bytes_rx for h in self.workers.values()
            if h.channel is not None)

    @property
    def n_dup_frames(self) -> int:
        return sum(h.channel.n_dup_frames for h in self.workers.values()
                   if h.channel is not None)

    @property
    def n_delayed_frames(self) -> int:
        return sum(h.channel.n_delayed_frames for h in self.workers.values()
                   if h.channel is not None)

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        self.supervisor.shutdown()

    def __del__(self) -> None:   # pragma: no cover - interpreter teardown
        try:
            self.supervisor.shutdown()
        except Exception:
            pass
