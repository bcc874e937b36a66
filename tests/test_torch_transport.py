"""The port's frame transport (no subprocesses — pure codec/channel), the
cases of ``tests/test_transport.py`` restated for torch tensors.

Covers the wire format (length-prefixed pickle frames with CRC32, the
header laid out byte for byte as the JAX package's), portable tensor
round-trips (bf16, ``float8_e4m3fn`` and int8 bit for bit), and the
FrameChannel chaos pipeline (blackhole hold/heal, duplicated and
reordered control frames) over a plain socketpair, plus the
``REPRO_PROC`` config grammar.  The card's case (a CUDA tensor leaves
``to_portable`` on the CPU) is in ``tests/test_torch_cuda.py``.
"""

import pickle
import socket
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from repro.core import transport as jtransport
from repro_torch.core import FaultPlane, ProcConfig
from repro_torch.core.transport import (
    ChecksumError,
    FrameChannel,
    HEADER_BYTES,
    MAGIC,
    TransportError,
    WorkerDied,
    decode_value,
    encode_frame,
    encode_value,
    split_frames,
    to_portable,
)


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------

def test_frame_roundtrip_with_tensors():
    arr = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    msg = {"kind": "exec_done", "outs": [{"latents": arr}], "req": 7}
    buf = bytearray(encode_frame(msg))
    (got,) = split_frames(buf)
    assert not buf                       # fully consumed
    assert got["kind"] == "exec_done" and got["req"] == 7
    out = got["outs"][0]["latents"]
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    torch.testing.assert_close(out, arr, rtol=0, atol=0)


def test_split_frames_handles_partial_and_multiple():
    f1 = encode_frame({"kind": "hb", "n": 1})
    f2 = encode_frame({"kind": "hb", "n": 2})
    buf = bytearray(f1 + f2[: len(f2) // 2])
    msgs = split_frames(buf)
    assert [m["n"] for m in msgs] == [1]
    buf.extend(f2[len(f2) // 2:])
    assert [m["n"] for m in split_frames(buf)] == [2]


def test_corrupted_payload_raises_checksum_error():
    frame = bytearray(encode_frame({"kind": "exec_done", "x": 1}))
    frame[HEADER_BYTES + 2] ^= 0xFF
    with pytest.raises(ChecksumError):
        split_frames(frame)


def test_bad_magic_raises_transport_error():
    frame = bytearray(encode_frame({"kind": "hb"}))
    frame[0:4] = b"XXXX"
    with pytest.raises(TransportError):
        split_frames(frame)


def test_value_roundtrip_bitexact():
    v = {"a": torch.linspace(0, 1, 17), "b": [1, (2.5, "s")], "c": None}
    got = decode_value(encode_value(v))
    torch.testing.assert_close(got["a"], v["a"], rtol=0, atol=0)
    assert got["b"] == [1, (2.5, "s")] and got["c"] is None


def test_to_portable_preserves_container_shapes():
    out = to_portable((torch.ones(3), {"k": [torch.zeros(2)]}, "txt",
                       np.arange(3)))
    assert isinstance(out, tuple) and isinstance(out[0], torch.Tensor)
    assert isinstance(out[1]["k"][0], torch.Tensor) and out[2] == "txt"
    assert isinstance(out[3], np.ndarray)            # numpy leaves stay
    assert all(t.device.type == "cpu" and t.is_contiguous()
               for t in (out[0], out[1]["k"][0]))


def test_worker_died_carries_reason():
    err = WorkerDied(3, "heartbeat")
    assert err.executor_id == 3 and err.reason == "heartbeat"
    assert "worker 3" in str(err) and "heartbeat" in str(err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.int8])
def test_narrow_dtypes_roundtrip_bit_for_bit(dtype):
    """The quantized forms (int8 and fp8 weights, bf16 projections) cross
    the wire with their bits, in containers, as views and as 0-d and empty
    tensors."""
    r = np.random.default_rng(0)
    base = torch.from_numpy(r.standard_normal((5, 7)).astype(np.float32) * 9)
    t = base.to(torch.int8) if dtype == torch.int8 else base.to(dtype)
    v = {"w": t, "view": [t[1:3, 2:]], "t": (t.t(),), "s": t[2, 3],
         "e": t[:0]}
    got = decode_value(encode_value(v))
    for key, want, have in (("w", t, got["w"]),
                            ("view", t[1:3, 2:], got["view"][0]),
                            ("t", t.t(), got["t"][0]),
                            ("s", t[2, 3], got["s"]),
                            ("e", t[:0], got["e"])):
        assert have.dtype == dtype and have.shape == want.shape, key
        assert torch.equal(_bits(have), _bits(want)), key
    # a view carries its own elements, not the storage it looks into
    big = torch.zeros(100_000, dtype=dtype)
    assert len(encode_value(big[:4])) < 1000


def test_frame_header_matches_the_jax_package():
    """The header is ``MAGIC | len | crc32`` in the JAX package's layout,
    byte for byte, for the same payload; a message without tensors is the
    same frame in both packages."""
    msg = {"kind": "exec_done", "req": 3, "outs": [{"x": torch.ones(4)}]}
    frame = encode_frame(msg)
    payload = frame[HEADER_BYTES:]
    want = jtransport._HEADER.pack(jtransport.MAGIC, len(payload),
                                   zlib.crc32(payload))
    assert frame[:HEADER_BYTES] == want
    assert HEADER_BYTES == jtransport.HEADER_BYTES == 12
    assert MAGIC == jtransport.MAGIC
    assert struct.unpack(">4sII", frame[:12]) == (
        b"LDTP", len(payload), zlib.crc32(payload))
    plain = {"kind": "need", "req": 9, "keys": ["a", "b"], "x": (1, 2.5)}
    assert encode_frame(plain) == jtransport.encode_frame(plain)
    assert pickle.loads(payload)["outs"][0]["x"].dtype == torch.float32


# --------------------------------------------------------------------------
# channel chaos pipeline (socketpair, no subprocess)
# --------------------------------------------------------------------------

@pytest.fixture
def channel_pair():
    a, b = socket.socketpair()
    yield a, b
    a.close()
    b.close()


def _send(sock, msg):
    sock.sendall(encode_frame(msg))


def test_heartbeats_filtered_and_refresh_liveness(channel_pair):
    worker, parent = channel_pair
    ch = FrameChannel(parent, worker_id=0)
    ch.last_rx = 0.0
    _send(worker, {"kind": "hb", "worker": 0})
    _send(worker, {"kind": "exec_done", "req": 1})
    msgs = ch.poll(0.5)
    assert [m["kind"] for m in msgs] == ["exec_done"]
    assert ch.n_hb_rx == 1
    assert ch.last_rx > 0.0              # heartbeat renewed the lease


def test_blackhole_holds_frames_without_renewing_lease(channel_pair):
    worker, parent = channel_pair
    ch = FrameChannel(parent, worker_id=0)
    ch.blackhole_until = time.monotonic() + 0.15
    ch.last_rx = 0.0
    _send(worker, {"kind": "hb", "worker": 0})
    _send(worker, {"kind": "exec_done", "req": 9})
    assert ch.poll(0.3) == []            # held, not dropped
    assert ch.last_rx == 0.0             # the lease is NOT renewed
    time.sleep(0.2)
    msgs = ch.poll(0.1)                  # healed: queued traffic arrives late
    assert [m["kind"] for m in msgs] == ["exec_done"]
    assert ch.last_rx > 0.0


def test_duplicate_frame_delivered_twice(channel_pair):
    worker, parent = channel_pair
    ch = FrameChannel(parent, worker_id=0, faults=FaultPlane(frame_dup_p=1.0))
    _send(worker, {"kind": "exec_done", "req": 4})
    msgs = ch.poll(0.5)
    assert [m["req"] for m in msgs] == [4, 4]
    assert ch.n_dup_frames == 1


def test_delayed_frame_reordered_behind_next_poll(channel_pair):
    worker, parent = channel_pair
    ch = FrameChannel(parent, worker_id=0,
                      faults=FaultPlane(frame_delay_p=1.0))
    _send(worker, {"kind": "exec_done", "req": 1})
    assert ch.poll(0.5) == []            # held for reorder
    _send(worker, {"kind": "exec_done", "req": 2})
    msgs = ch.poll(0.5)                  # old frame lands AFTER newer one
    assert [m["req"] for m in msgs] == [1]  # req 2 now held in its place
    assert ch.n_delayed_frames == 2


def test_channel_eof_on_peer_close(channel_pair):
    worker, parent = channel_pair
    ch = FrameChannel(parent, worker_id=0)
    worker.close()
    assert ch.poll(0.2) == []
    assert ch.eof


# --------------------------------------------------------------------------
# REPRO_FAULTS / REPRO_PROC grammar
# --------------------------------------------------------------------------

def test_faults_from_env_unknown_key_names_the_key():
    """A typo in the REPRO_FAULTS grammar fails loudly, naming the bad
    key and listing the known ones — not silently building a plane with
    the fault dropped."""
    with pytest.raises(ValueError) as exc:
        FaultPlane.from_env("crash_evry=5,seed=7")
    msg = str(exc.value)
    assert "unknown key 'crash_evry'" in msg
    assert "REPRO_FAULTS" in msg
    assert "crash_every" in msg          # the fix is in the message


def test_faults_from_env_proc_fault_keys():
    """Process-level fault keys (and their aliases) are part of the
    REPRO_FAULTS grammar."""
    fp = FaultPlane.from_env(
        "kill_every=3,max_kills=1,blackhole_exec=5,blackhole_for=0.4,"
        "frame_dup_p=0.1,frame_delay_p=0.2,seed=9")
    assert (fp.kill_every_execs, fp.max_kills, fp.blackhole_exec,
            fp.blackhole_seconds) == (3, 1, 5, 0.4)
    assert (fp.frame_dup_p, fp.frame_delay_p) == (0.1, 0.2)


def test_proc_config_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_PROC",
                       "hb_interval=0.02,hb_timeout=0.5,staging_entries=64")
    cfg = ProcConfig.from_env()
    assert (cfg.hb_interval, cfg.hb_timeout, cfg.staging_entries) == \
        (0.02, 0.5, 64)
    monkeypatch.delenv("REPRO_PROC")
    assert ProcConfig.from_env() == ProcConfig()


def test_proc_config_unknown_key_raises():
    with pytest.raises(ValueError, match="unknown key 'hb_intervl'"):
        ProcConfig.from_env("hb_intervl=0.02")
