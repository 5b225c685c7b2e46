"""Worker processes on a socket transport: the port of
``repro/async_engine/proc.py``.

The parent spawns one process per worker (``multiprocessing``'s "spawn"
context: a fresh interpreter, never a fork of a parent that has initialised
CUDA), a socket rendezvous assigns each its worker id, and the runtime's
``Envelope`` and ``Ack`` frames travel over length-prefixed sockets. The
delivery protocol is the threaded runtime's: children run the same
``ReliableSender`` and the same ``execute_round``, the parent keeps its
``DeliveryTracker``, and ``FaultyTransport`` wraps the child's side of the
wire, so a chaos scenario runs unchanged over processes.

Wire format
-----------

One frame is a ``!II`` header (payload length, CRC32 of the payload bytes)
followed by a pickled tuple ``(tag, ...)``, byte for byte the reference's:

  parent <- child   ("join", {nonce, pid})        rendezvous hello
                    ("join", {nonce, pid, channel: "hb"})
                                                  the heartbeat connection
                    ("msg", Envelope)             credited data frame
                    ("hb", Envelope)              uncredited heartbeat
                    ("ctrl", "obs", {...})        span batch and wire
                                                  counters, every
                                                  ``obs_every`` rounds and
                                                  once ``final`` at stop
                    ("ctrl", "stats", {...})      fault, protocol and work
                                                  tallies at graceful stop
                    ("ctrl", "fatal", {...})      the child could not start
  parent -> child   ("assign", {wid, credit, cfg, faults, mode, device,
                               torch settings, hb_nonce, t_parent, obs,
                               obs_every})
                    ("reject", reason)            no rendezvous slot
                    ("task", RoundTask, clock)    dispatched round
                    ("ack", Ack)                  delivery receipt
                    ("credit", n)                 flow-control top-up
                    ("stop",)                     graceful shutdown

A child that beats (free mode with liveness on) sends its beacons on a
second connection, joined with the one-time ``hb_nonce`` of its assign
frame, where the reference shares one: a connection's frames are read in
order by one thread, so at full width a beacon queued behind a ~192 MB
result frame (its transfer, CRC and unpickle) reached the parent later
than the liveness threshold allows, and a beacon waited on the child's
send lock for the whole frame.

Payloads cross the wire in host form (``host_tree``): every tensor a numpy
array (a bf16 one as its int16 pattern), so fp32 and int8 bytes round-trip
exactly and ``payload_crc`` is the same on both sides; ``device_tree``
puts them back on the receiver's device. A corrupted frame (header CRC
mismatch) raises ``WireError`` and tears the connection down; injected
corruption flips ``Envelope.crc`` instead and is rejected by the parent's
``DeliveryTracker`` as on the in-process path.

Rendezvous
----------

``WorkerProcessPool.ensure(wid)`` registers a one-time nonce, spawns the
child with ``(address, nonce)`` and blocks until the child presents it; the
parent then assigns the worker id and ships the ``RunConfig``, the
``FaultSpec``, the device and the torch settings the port relies on (the
intra-op thread count, the TF32 switches and the fp32 matmul precision),
which a spawned interpreter would otherwise take from torch's defaults. A
join with an unknown or used nonce is rejected; a child that dies first
fails ``ensure``; ``close`` stops, joins and terminates, leaving no
orphan. A child resolves its device with ``resolve_device``: asked for
CUDA where there is none it raises and reports a ``WorkerFatal``, never
computing on the CPU instead.

Flow control and crash recovery are the reference's: each connection holds
``capacity`` credits, a data frame costs one and ``recv`` returns it; a
worker process whose connection drops outside a graceful stop surfaces as a
``WorkerExit`` in the parent's receive stream, and the runtime respawns it
and resubmits the same ``RoundTask`` snapshot (same task id), so a
deterministic run replays its golden straight through a process kill.

Observability: a pool built with ``obs=True`` has each child run its own
``obs.spans.SpanTracer`` (its rounds and its sender's transport spans) and
ship the new spans with its cumulative wire counters, rounds and compute
seconds as an obs frame every ``obs_every`` rounds and once more, marked
``final``, at its graceful stop, ahead of its stats frame. The frames go on
the data connection, small and rare beside the result frames. Span times
stay in the child's clock; the parent re-bases them with ``epoch_offset``,
the child's tracer epoch plus its rendezvous clock offset. ``on_obs``
receives each payload; ``obs_reports`` and ``obs_final`` count them.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import socket
import struct
import sys
import tempfile
import threading
import time
import types
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.async_engine.engine import (
    RoundResult, RoundTask, execute_round,
)
from repro_torch.async_engine.faults import FaultyTransport
from repro_torch.async_engine.transport import (
    AckWaiter, Bf16Bits, Envelope, KIND_ERROR, KIND_HEARTBEAT, KIND_RESULT,
    ReliableSender, Transport, TransportClosed, TransportTimeout,
    payload_crc,
)

_HDR = struct.Struct("!II")          # (payload length, CRC32 of payload)
_MAX_FRAME = 1 << 30
# a received array's bytes are copied in slices of this many
_COPY_SLICE = 4 << 20
# AF_UNIX paths are limited to 108 bytes on Linux: a longer one goes TCP
_MAX_UNIX_PATH = 100


class WireError(Exception):
    """Malformed or checksum-failed frame on the wire (connection-fatal)."""


class RendezvousRejected(Exception):
    """The parent refused this join (unknown or already-used nonce)."""


@dataclass(frozen=True)
class WorkerExit:
    """Surfaced in the parent's receive stream when a worker process'
    connection drops outside a graceful shutdown."""
    wid: int
    incarnation: int


@dataclass(frozen=True)
class WorkerFatal:
    """A worker process could not start (no device, no model): surfaced in
    the parent's receive stream ahead of its ``WorkerExit``, and raised by
    the runtime."""
    wid: int
    incarnation: int
    error: str


# ---------------------------------------------------------------------------
# Frame I/O
# ---------------------------------------------------------------------------

def _pickle_pieces(obj: Any) -> list:
    """``obj`` pickled as ``pickle.dumps`` pickles it, as the list of its
    pieces in order: the pickler hands a payload of 64 KiB or more (an
    array's bytes, as protocol 5's ``PickleBuffer``) to its file as it lies
    in memory, so no array is copied and no whole-frame copy holds the
    GIL."""
    pieces: list = []
    pickle.Pickler(types.SimpleNamespace(write=pieces.append),
                   protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return pieces


def _send_frame(sock: socket.socket, lock: threading.Lock, obj: Any,
                stats: Optional[Dict[str, Any]] = None) -> None:
    t0 = time.perf_counter()
    pieces = _pickle_pieces(obj)
    if stats is not None:
        stats["ser_s"] += time.perf_counter() - t0
    length, crc = 0, 0
    for piece in pieces:
        length += memoryview(piece).nbytes
        crc = zlib.crc32(piece, crc)
    hdr = _HDR.pack(length, crc & 0xFFFFFFFF)
    with lock:
        # the reference's bytes, each piece sent from where it lies (the
        # GIL released for the transfer)
        sock.sendall(hdr)
        for piece in pieces:
            sock.sendall(piece)
        if stats is not None:
            stats["frames_sent"] += 1
            stats["bytes_sent"] += len(hdr) + length


def _read_exact(sock: socket.socket, n: int) -> np.ndarray:
    """``n`` bytes into one buffer, waiting for all of them in the kernel:
    one call, the GIL released throughout, where reading whatever each
    ``recv`` returns would take the GIL again per socket buffer (hundreds
    of times a frame, each a wait behind the process' busy threads). The
    buffer is not zeroed first: that too would hold the GIL."""
    buf = np.empty(n, np.uint8)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got, socket.MSG_WAITALL)
        if not k:
            raise EOFError("connection closed mid-frame")
        got += k
    return buf


class _SliceReader:
    """A received payload as ``pickle.Unpickler``'s file. An array's bytes
    go into the object that takes them _COPY_SLICE bytes at a time, and
    between two slices the GIL can pass to the process' other threads (a
    child's beacon sender, the parent's heartbeat reader), where
    ``pickle.loads`` holds it for a whole frame's copies."""

    def __init__(self, buf):
        self._view = memoryview(buf).cast("B")
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        end = len(self._view) if n < 0 else min(len(self._view),
                                                 self._pos + n)
        out = bytes(self._view[self._pos:end])
        self._pos = end
        return out

    def readinto(self, b) -> int:
        dst = memoryview(b).cast("B")
        n = min(len(dst), len(self._view) - self._pos)
        for i in range(0, n, _COPY_SLICE):
            j = min(n, i + _COPY_SLICE)
            dst[i:j] = self._view[self._pos + i:self._pos + j]
        self._pos += n
        return n

    def readline(self) -> bytes:
        # the unpickler asks for it to exist; protocol 5, both sides'
        # writers', has no text opcode that calls it
        raise pickle.UnpicklingError("no text line in a protocol 5 frame")


def _recv_frame(sock: socket.socket,
                stats: Optional[Dict[str, Any]] = None) -> Any:
    length, crc = _HDR.unpack(_read_exact(sock, _HDR.size))
    if length > _MAX_FRAME:
        raise WireError(f"frame length {length} exceeds cap")
    data = _read_exact(sock, length)
    if zlib.crc32(data) & 0xFFFFFFFF != crc:
        if stats is not None:
            stats["crc_rejects"] += 1
        raise WireError("frame CRC mismatch on the wire")
    t0 = time.perf_counter()
    obj = pickle.Unpickler(_SliceReader(data)).load()
    if stats is not None:
        stats["deser_s"] += time.perf_counter() - t0
        stats["frames_recv"] += 1
        stats["bytes_recv"] += _HDR.size + length
    return obj


def _new_wire_stats() -> Dict[str, Any]:
    """Per-connection wire counters (the vocabulary of the telemetry
    schema's ``TransportMetrics``, minus the compute fields). Updated under
    the send lock or by the single reader thread."""
    return {"frames_sent": 0, "frames_recv": 0, "bytes_sent": 0,
            "bytes_recv": 0, "ser_s": 0.0, "deser_s": 0.0,
            "crc_rejects": 0, "credit_wait_s": 0.0}


# ---------------------------------------------------------------------------
# Host form of payloads
# ---------------------------------------------------------------------------

def host_tree(x: Any) -> Any:
    """Device -> host: every tensor of ``x`` (a tensor, or dicts, tuples
    and NamedTuples of them, ``Packed`` included) a numpy array; fp32 and
    int8 bytes round-trip exactly."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            return Bf16Bits(t.view(torch.int16).cpu().numpy())
        return t.cpu().numpy()
    if isinstance(x, dict):
        return {k: host_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(host_tree(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(host_tree(v) for v in x)
    return x


def device_tree(x: Any, device) -> Any:
    """Host -> device: ``host_tree``'s inverse on ``device``."""
    device = torch.device(device)
    # an unpickled array owns its bytes (pickle's in-band bytearray): on the
    # CPU the tensor shares them, a copy to the card reads them once
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(device)
    if isinstance(x, Bf16Bits):
        return torch.from_numpy(x.bits).to(device).view(torch.bfloat16)
    if isinstance(x, dict):
        return {k: device_tree(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(device_tree(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(device_tree(v, device) for v in x)
    return x


def host_task(task: RoundTask) -> RoundTask:
    """Wire form of a dispatched round: its tensors on the host, the
    device pin stripped (children own their devices)."""
    return dataclasses.replace(
        task, params=host_tree(task.params), opt=host_tree(task.opt),
        ef=host_tree(task.ef), device=None)


def device_task(task: RoundTask, device) -> RoundTask:
    """``host_task``'s inverse: the round's tensors on ``device``."""
    return dataclasses.replace(
        task, params=device_tree(task.params, device),
        opt=device_tree(task.opt, device), ef=device_tree(task.ef, device))


def host_result(res: RoundResult) -> RoundResult:
    """Wire form of a finished round: its tensors on the host."""
    return dataclasses.replace(res, delta=host_tree(res.delta),
                               opt=host_tree(res.opt), ef=host_tree(res.ef))


def device_result(res: RoundResult, device) -> RoundResult:
    """``host_result``'s inverse: the round's tensors on ``device``."""
    return dataclasses.replace(
        res, delta=device_tree(res.delta, device),
        opt=device_tree(res.opt, device), ef=device_tree(res.ef, device))


def _host_envelope(env: Envelope) -> Envelope:
    if isinstance(env.payload, RoundResult):
        return dataclasses.replace(env, payload=host_result(env.payload))
    return env


# ---------------------------------------------------------------------------
# Parent side: SocketTransport
# ---------------------------------------------------------------------------

class _Conn:
    """One accepted connection (registry entry and best-effort sender)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.lock = threading.Lock()
        self.wid: Optional[int] = None
        self.incarnation: int = 0
        self.alive = True

    def send(self, obj: Any) -> bool:
        try:
            _send_frame(self.sock, self.lock, obj)
            return True
        except (OSError, ValueError):
            self.alive = False
            return False

    def kill(self):
        self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _default_family() -> str:
    fam = os.environ.get("REPRO_SOCKET_FAMILY", "")
    if fam in ("unix", "tcp"):
        return fam
    return "unix" if hasattr(socket, "AF_UNIX") else "tcp"


class SocketTransport(Transport):
    """The parent's end of the socket backend, a ``Transport``: ``send``
    goes through a loopback client over the real wire (so it can stand in
    for ``InProcTransport`` anywhere and ``FaultyTransport`` can wrap it),
    ``recv`` drains the frames the per-connection reader threads push.
    Bounded, FIFO per connection, ``close`` wakes everyone, exact timeout
    deadlines: ``InProcTransport``'s contract over sockets."""

    def __init__(self, capacity: int = 8, family: Optional[str] = None,
                 hb_sink: Optional[Transport] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.family = family or _default_family()
        self.hb_sink = hb_sink
        # pool hooks (None on a standalone transport):
        self.on_join: Optional[Callable[["_Conn", Dict], Optional[Dict]]] \
            = None
        self.on_ready: Optional[Callable[["_Conn"], None]] = None
        self.on_exit: Optional[Callable[["_Conn"], None]] = None
        self.on_control: Optional[Callable[["_Conn", str, Any], None]] = None
        self._dq: list = []                      # [(msg, conn or None)]
        self._not_empty = threading.Condition(threading.Lock())
        self._reg_lock = threading.Lock()
        self._conns: list = []
        self._closed = False
        self._tmpdir: Optional[str] = None
        self._loop_client: Optional["SocketClient"] = None
        self._loop_lock = threading.Lock()
        if self.family == "unix":
            self._tmpdir = tempfile.mkdtemp(prefix="heloco-sock-")
            path = os.path.join(self._tmpdir, "s")
            if len(path) > _MAX_UNIX_PATH:
                os.rmdir(self._tmpdir)
                self._tmpdir = None
                self.family = "tcp"
        if self.family == "unix":
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            self._listener.bind(path)
            self.address: Tuple[str, Any] = ("unix", path)
        else:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind(("127.0.0.1", 0))
            self.address = ("tcp", self._listener.getsockname())
        self._listener.listen(64)
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          name="heloco-sock-accept",
                                          daemon=True)
        self._acceptor.start()

    # -------------------------------------------------------------- accept
    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return                           # listener closed
            if self._closed:                     # close()'s wake-up call
                sock.close()
                return
            conn = _Conn(sock)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             name="heloco-sock-conn", daemon=True).start()

    def _conn_loop(self, conn: _Conn):
        try:
            frame = _recv_frame(conn.sock)
        except (EOFError, OSError, WireError, pickle.UnpicklingError):
            conn.kill()
            return
        if not (isinstance(frame, tuple) and frame
                and frame[0] == "join"):
            conn.send(("reject", "expected a join frame"))
            conn.kill()
            return
        info = frame[1] if len(frame) > 1 else {}
        if self.on_join is not None:
            payload = self.on_join(conn, info)
        else:                                    # standalone or loopback
            payload = {"wid": None, "credit": self.capacity}
        if payload is None:
            conn.send(("reject", "no pending rendezvous slot for this "
                                 "join (duplicate or unknown nonce)"))
            conn.kill()
            return
        with self._reg_lock:
            if self._closed:
                conn.send(("reject", "transport closed"))
                conn.kill()
                return
            self._conns.append(conn)
        if not conn.send(("assign", payload)):
            return
        if self.on_ready is not None:
            self.on_ready(conn)
        try:
            while True:
                frame = _recv_frame(conn.sock)
                tag = frame[0]
                if tag == "msg":
                    with self._not_empty:
                        self._dq.append((frame[1], conn))
                        self._not_empty.notify()
                elif tag == "hb":
                    if self.hb_sink is not None:
                        try:
                            self.hb_sink.send(frame[1], timeout=0.01)
                        except (TransportTimeout, TransportClosed):
                            pass                 # side channel full: drop
                    else:
                        with self._not_empty:
                            self._dq.append((frame[1], None))
                            self._not_empty.notify()
                elif tag == "ctrl":
                    if self.on_control is not None:
                        self.on_control(conn, frame[1], frame[2])
        except (EOFError, OSError, WireError, pickle.UnpicklingError):
            pass
        finally:
            conn.kill()
            with self._reg_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            if not self._closed and self.on_exit is not None:
                self.on_exit(conn)

    # ------------------------------------------------------- local inject
    def push_local(self, msg: Any):
        """Parent-side injection (``WorkerExit``, ``WorkerFatal``): no wire,
        no credit."""
        with self._not_empty:
            self._dq.append((msg, None))
            self._not_empty.notify()

    # ---------------------------------------------------------- Transport
    def _loopback(self) -> "SocketClient":
        with self._loop_lock:
            if self._loop_client is None or self._loop_client.closed:
                if self._closed:
                    raise TransportClosed("send on closed transport")
                self._loop_client = SocketClient.connect(
                    self.address, {"kind": "loopback"}, timeout=10.0)
                self._loop_client.start()
            return self._loop_client

    def send(self, msg: Any, timeout: Optional[float] = None) -> None:
        if self._closed:
            raise TransportClosed("send on closed transport")
        self._loopback().send_data(msg, timeout=timeout)

    def recv(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_empty:
            while True:
                if self._dq:
                    msg, conn = self._dq.pop(0)
                    break
                if self._closed:
                    raise TransportClosed("recv on closed, drained "
                                          "transport")
                if deadline is None:
                    self._not_empty.wait()
                else:
                    rest = deadline - time.monotonic()
                    if rest <= 0:
                        raise TransportTimeout(f"recv idle > {timeout}s")
                    self._not_empty.wait(rest)
        if conn is not None and conn.alive:
            conn.send(("credit", 1))             # return the flow credit
        return msg

    def close(self) -> None:
        with self._not_empty:
            if self._closed:
                return
            self._closed = True
            self._not_empty.notify_all()
        # a thread blocked in accept() holds the transport, its pool and
        # the pool's runtime alive, and closing the listener does not wake
        # it on every kernel: one connection does
        if threading.current_thread() is not self._acceptor:
            try:
                with socket.socket(socket.AF_UNIX if self.family == "unix"
                                   else socket.AF_INET) as wake:
                    wake.settimeout(5.0)
                    wake.connect(self.address[1])
            except OSError:
                pass
            self._acceptor.join(timeout=5.0)
        try:
            self._listener.close()
        except OSError:
            pass
        with self._loop_lock:
            if self._loop_client is not None:
                self._loop_client.close()
        with self._reg_lock:
            conns, self._conns = list(self._conns), []
        for conn in conns:
            conn.kill()
        if self._tmpdir is not None:
            try:
                os.unlink(self.address[1])
            except OSError:
                pass
            try:
                os.rmdir(self._tmpdir)
            except OSError:
                pass
            self._tmpdir = None

    def depth(self) -> int:
        return len(self._dq)


# ---------------------------------------------------------------------------
# Client side (children and the loopback)
# ---------------------------------------------------------------------------

class SocketClient:
    """The worker end of a connection: credited data sends, uncredited
    heartbeats, and a reader thread routing acks, tasks, credits and stop
    to callbacks."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._cond = threading.Condition()
        self._credits = 0
        self.closed = False
        self.assign: Dict[str, Any] = {}
        #: cumulative wire counters (frames, bytes, ser, deser, crc, credit)
        self.wire: Dict[str, Any] = _new_wire_stats()
        #: child -> parent perf_counter offset estimated at the rendezvous
        #: (parent_time ~= child_time + clock_offset); 0.0 when the assign
        #: reply carried no parent timestamp (standalone)
        self.clock_offset = 0.0
        self.on_ack: Optional[Callable[[Any], None]] = None
        self.on_task: Optional[Callable[[Any, Any], None]] = None
        self.on_stop: Optional[Callable[[], None]] = None
        self.on_disconnect: Optional[Callable[[], None]] = None
        self._reader: Optional[threading.Thread] = None

    @classmethod
    def connect(cls, address: Tuple[str, Any], join_info: Dict,
                timeout: float = 30.0) -> "SocketClient":
        family, target = address
        if family == "unix":
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(timeout)
            sock.connect(target)
        else:
            sock = socket.create_connection(tuple(target), timeout=timeout)
        client = cls(sock)
        try:
            # the join -> assign round trip doubles as the clock-offset
            # probe: the parent stamps its perf_counter into the assign
            # payload, and the midpoint of [t0, t1] estimates when
            t0 = time.perf_counter()
            _send_frame(sock, client._send_lock, ("join", dict(join_info)),
                        client.wire)
            frame = _recv_frame(sock, client.wire)
            t1 = time.perf_counter()
        except (EOFError, OSError, WireError) as e:
            sock.close()
            raise RendezvousRejected(f"rendezvous failed: {e!r}") from e
        if frame[0] == "reject":
            sock.close()
            raise RendezvousRejected(frame[1])
        if frame[0] != "assign":
            sock.close()
            raise RendezvousRejected(f"unexpected frame {frame[0]!r}")
        sock.settimeout(None)
        client.assign = frame[1]
        client._credits = int(client.assign.get("credit", 8))
        t_parent = client.assign.get("t_parent")
        if t_parent is not None:
            client.clock_offset = float(t_parent) - (t0 + t1) / 2.0
        return client

    def start(self):
        self._reader = threading.Thread(target=self._read_loop,
                                        name="heloco-sock-client",
                                        daemon=True)
        self._reader.start()

    def _read_loop(self):
        try:
            while True:
                frame = _recv_frame(self._sock, self.wire)
                tag = frame[0]
                if tag == "credit":
                    with self._cond:
                        self._credits += frame[1]
                        self._cond.notify_all()
                elif tag == "ack":
                    if self.on_ack is not None:
                        self.on_ack(frame[1])
                elif tag == "task":
                    if self.on_task is not None:
                        self.on_task(frame[1], frame[2])
                elif tag == "stop":
                    if self.on_stop is not None:
                        self.on_stop()
        except (EOFError, OSError, WireError, pickle.UnpicklingError):
            pass
        finally:
            with self._cond:
                self.closed = True
                self._cond.notify_all()
            if self.on_disconnect is not None:
                self.on_disconnect()

    # --------------------------------------------------------------- sends
    def send_data(self, msg: Any, timeout: Optional[float] = None) -> None:
        """Credited send with ``InProcTransport``'s blocking semantics."""
        if isinstance(msg, Envelope):
            msg = _host_envelope(msg)
        deadline = None if timeout is None else time.monotonic() + timeout
        t_wait = time.perf_counter()
        with self._cond:
            while True:
                if self.closed:
                    raise TransportClosed("send on closed transport")
                if self._credits > 0:
                    self._credits -= 1
                    self.wire["credit_wait_s"] += (time.perf_counter()
                                                   - t_wait)
                    break
                if deadline is None:
                    self._cond.wait()
                else:
                    rest = deadline - time.monotonic()
                    if rest <= 0:
                        raise TransportTimeout(
                            f"send blocked > {timeout}s (window "
                            f"exhausted)")
                    self._cond.wait(rest)
        try:
            _send_frame(self._sock, self._send_lock, ("msg", msg),
                        self.wire)
        except (OSError, ValueError) as e:
            raise TransportClosed(f"send failed: {e!r}") from e

    def send_hb(self, env: Envelope) -> None:
        """Uncredited heartbeat beacon (side-channel semantics)."""
        if self.closed:
            raise TransportClosed("heartbeat on closed transport")
        try:
            _send_frame(self._sock, self._send_lock, ("hb", env), self.wire)
        except (OSError, ValueError) as e:
            raise TransportClosed(f"heartbeat failed: {e!r}") from e

    def send_ctrl(self, tag: str, obj: Any) -> None:
        _send_frame(self._sock, self._send_lock, ("ctrl", tag, obj),
                    self.wire)

    def close(self):
        with self._cond:
            self.closed = True
            self._cond.notify_all()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class _ChildChannel(Transport):
    """Child-side ``Transport`` over the shared ``SocketClient``, one per
    logical channel, so ``FaultyTransport`` wraps data and heartbeats
    apart, as the threaded runtime does."""

    def __init__(self, client: SocketClient, kind: str):
        assert kind in ("data", "hb")
        self.client = client
        self.kind = kind

    def send(self, msg: Any, timeout: Optional[float] = None) -> None:
        if self.kind == "data":
            self.client.send_data(msg, timeout=timeout)
        else:
            self.client.send_hb(msg)

    def recv(self, timeout: Optional[float] = None) -> Any:
        raise RuntimeError("child channels are send-only")

    def close(self) -> None:
        self.client.close()

    def depth(self) -> int:
        return 0


# ---------------------------------------------------------------------------
# Parent side: the worker-process pool
# ---------------------------------------------------------------------------

def torch_settings() -> Dict[str, Any]:
    """The process-wide torch settings a worker's bits depend on, which a
    spawned interpreter does not inherit."""
    return {"num_threads": torch.get_num_threads(),
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def apply_torch_settings(s: Dict[str, Any]) -> None:
    torch.set_num_threads(int(s["num_threads"]))
    torch.backends.cuda.matmul.allow_tf32 = bool(s["matmul_allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(s["cudnn_allow_tf32"])
    torch.set_float32_matmul_precision(s["float32_matmul_precision"])


class WorkerProcessPool:
    """Spawns and tracks one process per worker id, owns the rendezvous,
    and bridges the runtime's submit and ack calls onto per-connection
    frames. ``device``: where the children compute (each resolves it
    itself)."""

    RENDEZVOUS_TIMEOUT = 120.0

    def __init__(self, run_cfg, *, device="cuda", capacity: int = 8,
                 faults=None, mode: str = "deterministic",
                 pace_scale: float = 0.0,
                 hb_sink: Optional[Transport] = None,
                 family: Optional[str] = None,
                 obs: bool = False, obs_every: int = 4):
        self.run_cfg = run_cfg
        self.device = str(torch.device(device))
        self.faults = faults
        self.mode = mode
        self.pace_scale = pace_scale
        #: children trace and ship obs frames every ``obs_every`` rounds
        self.obs = bool(obs)
        self.obs_every = max(1, int(obs_every))
        #: the parent's hook for each child obs payload (the runtime's)
        self.on_obs: Optional[Callable[[Dict], None]] = None
        #: wid -> obs frames received (any incarnation)
        self.obs_reports: Dict[int, int] = {}
        #: wids whose final obs frame arrived
        self.obs_final: set = set()
        self.transport = SocketTransport(capacity=capacity, family=family,
                                         hb_sink=hb_sink)
        self.transport.on_join = self._on_join
        self.transport.on_ready = self._on_ready
        self.transport.on_exit = self._on_exit
        self.transport.on_control = self._on_control
        self._ctx = mp.get_context("spawn")
        self._lock = threading.Lock()
        self._pending: Dict[str, Tuple[int, int]] = {}   # nonce->(wid,inc)
        self._pending_hb: Dict[str, Tuple[int, int]] = {}
        self._conns: Dict[int, _Conn] = {}
        self._procs: Dict[int, Any] = {}
        self._inc: Dict[int, int] = {}
        self._ready: Dict[Tuple[int, int], threading.Event] = {}
        self._closing = False
        #: per-channel fault and protocol counters the children report at
        #: graceful stop: {"data": {...}, "heartbeat": {...},
        #: "protocol": {"retries": n, "stale_tasks_skipped": k}}
        self.child_counters: Dict[str, Dict[str, int]] = {}
        #: the children's kernel launches and rounds (graceful stops only),
        #: kept apart from the delivery counters
        self.child_launches: Dict[str, int] = {}
        self.child_rounds = 0
        self.proc_exits = 0
        #: the first child that could not start; no process is spawned after
        self.fatal: Optional[WorkerFatal] = None
        #: seconds from each spawn to its completed rendezvous
        self.spawn_seconds: Dict[Tuple[int, int], float] = {}
        self.clock: Tuple[Optional[float], float] = (None, pace_scale)

    # ----------------------------------------------------------- rendezvous
    def _beats(self) -> bool:
        """Whether the children send heartbeats (free mode, liveness on)."""
        return (self.faults is not None and self.faults.liveness_enabled
                and self.mode == "free")

    def _on_join(self, conn: _Conn, info: Dict) -> Optional[Dict]:
        nonce = info.get("nonce")
        hb = info.get("channel") == "hb"
        with self._lock:
            pending = self._pending_hb if hb else self._pending
            ent = pending.pop(nonce, None) if nonce else None
            if ent is None or self._closing:
                return None                      # reject (duplicate join)
            wid, inc = ent
            conn.wid, conn.incarnation = wid, inc
            if hb:                               # not the worker's registry
                return {"wid": wid, "credit": 0}
            self._conns[wid] = conn
            hb_nonce = f"{nonce}-hb" if self._beats() else None
            if hb_nonce is not None:
                self._pending_hb[hb_nonce] = (wid, inc)
        return {"wid": wid, "credit": self.transport.capacity,
                "cfg": self.run_cfg, "faults": self.faults,
                "mode": self.mode, "pace_scale": self.pace_scale,
                "device": self.device, "torch": torch_settings(),
                "hb_nonce": hb_nonce, "t_parent": time.perf_counter(),
                "obs": self.obs, "obs_every": self.obs_every}

    def _on_ready(self, conn: _Conn):
        ev = self._ready.get((conn.wid, conn.incarnation))
        if ev is not None:
            ev.set()

    def _on_exit(self, conn: _Conn):
        with self._lock:
            if self._closing or conn.wid is None:
                return
            if self._conns.get(conn.wid) is not conn:
                return                           # stale incarnation
            del self._conns[conn.wid]
            self.proc_exits += 1
        self.transport.push_local(WorkerExit(conn.wid, conn.incarnation))

    def _on_control(self, conn: _Conn, tag: str, obj: Any):
        if tag == "obs" and isinstance(obj, dict):
            wid = obj.get("wid", conn.wid)
            with self._lock:
                if wid is not None:
                    self.obs_reports[wid] = self.obs_reports.get(wid, 0) + 1
                    if obj.get("final"):
                        self.obs_final.add(wid)
            if self.on_obs is not None:
                self.on_obs(obj)
            return
        if tag == "fatal" and isinstance(obj, dict):
            self.fatal = WorkerFatal(conn.wid, conn.incarnation,
                                     str(obj.get("error")))
            self.transport.push_local(self.fatal)
            return
        if tag != "stats" or not isinstance(obj, dict):
            return
        obj = dict(obj)
        launches = obj.pop("launches", {})
        rounds = obj.pop("rounds", 0)
        with self._lock:
            for k, v in launches.items():
                self.child_launches[k] = self.child_launches.get(k, 0) + v
            self.child_rounds += int(rounds)
            for channel, counters in obj.items():
                acc = self.child_counters.setdefault(channel, {})
                for k, v in counters.items():
                    acc[k] = acc.get(k, 0) + int(v)

    # ------------------------------------------------------------ lifecycle
    def incarnation(self, wid: int) -> int:
        return self._inc.get(wid, 0)

    def alive(self, wid: int) -> bool:
        conn = self._conns.get(wid)
        return conn is not None and conn.alive

    def ensure(self, wid: int) -> Optional[int]:
        """Spawn (or respawn) the worker process for ``wid`` and complete
        the rendezvous. Returns the new incarnation when a process was
        started, None when a live one already serves the wid."""
        return self.ensure_many([wid]).get(wid)

    def ensure_many(self, wids) -> Dict[int, int]:
        """``ensure`` for several wids, the processes started together and
        then awaited: ``{wid: incarnation}`` of those started."""
        started = {}
        for wid in wids:
            got = self._spawn(wid)
            if got is not None:
                started[wid] = got
        for wid, (inc, nonce, proc, ready, t0) in started.items():
            self._await(wid, inc, nonce, proc, ready, t0)
        return {wid: ent[0] for wid, ent in started.items()}

    def _spawn(self, wid: int):
        with self._lock:
            if self._closing:
                raise TransportClosed("worker pool closed")
            if self.fatal is not None:
                raise RuntimeError(f"worker {self.fatal.wid}'s process could "
                                   f"not start: {self.fatal.error}")
            conn = self._conns.get(wid)
            if conn is not None and conn.alive:
                return None
            inc = self._inc.get(wid, 0) + 1
            self._inc[wid] = inc
            nonce = f"w{wid}-i{inc}-p{os.getpid()}"
            self._pending[nonce] = (wid, inc)
            ready = threading.Event()
            self._ready[(wid, inc)] = ready
        t0 = time.perf_counter()
        proc = self._ctx.Process(target=_worker_main,
                                 args=(self.transport.address, nonce),
                                 name=f"heloco-proc-{wid}", daemon=True)
        proc.start()
        with self._lock:
            self._procs[wid] = proc
        return inc, nonce, proc, ready, t0

    def _await(self, wid, inc, nonce, proc, ready, t0):
        deadline = time.monotonic() + self.RENDEZVOUS_TIMEOUT
        while not ready.wait(0.05):
            if not proc.is_alive():
                with self._lock:
                    self._pending.pop(nonce, None)
                    self._ready.pop((wid, inc), None)
                raise RuntimeError(
                    f"worker {wid} died before the rendezvous completed "
                    f"(exit code {proc.exitcode})")
            if time.monotonic() > deadline:
                proc.terminate()
                with self._lock:
                    self._pending.pop(nonce, None)
                    self._ready.pop((wid, inc), None)
                raise RuntimeError(f"worker {wid} rendezvous timed out "
                                   f"after {self.RENDEZVOUS_TIMEOUT}s")
        self._ready.pop((wid, inc), None)
        self.spawn_seconds[(wid, inc)] = time.perf_counter() - t0

    # ------------------------------------------------------------- data path
    def submit(self, wid: int, task: RoundTask) -> None:
        """Frame a dispatched round to the worker's process. A send to a
        connection that just died is not an error: the reader thread
        surfaces a ``WorkerExit`` and the runtime resubmits."""
        conn = self._conns.get(wid)
        if conn is None:
            raise TransportClosed(f"worker {wid} has no live process")
        conn.send(("task", host_task(task), self.clock))

    def send_ack(self, wid: int, ack) -> None:
        conn = self._conns.get(wid)
        if conn is not None:
            conn.send(("ack", ack))

    def kill(self, wid: int) -> None:
        """Hard-remove a worker process (elastic leave, test kill).
        Deregisters first, so no ``WorkerExit`` is surfaced."""
        with self._lock:
            conn = self._conns.pop(wid, None)
            proc = self._procs.pop(wid, None)
        if conn is not None:
            conn.kill()
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(timeout=5.0)

    def close(self) -> None:
        """Graceful stop, stats harvest, join, terminate stragglers, close
        the listener. No orphan process survives this."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            conns = list(self._conns.values())
            self._conns.clear()
            procs = list(self._procs.values())
            self._procs.clear()
        for conn in conns:
            conn.send(("stop",))
        for proc in procs:
            proc.join(timeout=10.0)
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        for proc in procs:
            if proc.is_alive():
                proc.join(timeout=5.0)
        self.transport.close()


# ---------------------------------------------------------------------------
# Child side: the worker process entry point
# ---------------------------------------------------------------------------

_STOP = object()
_EOF = object()


class _TaskSlot:
    """The child's task intake: only the newest dispatched task waits.
    Every dispatch moves the worker's pending round to its newest task, so
    a task overtaken before the loop takes it could never commit; it is
    dropped on arrival (counted in ``skipped``), and its ~192 MB host copy
    with it. A queue would keep every one: while a round and its delivery
    run, each false liveness death and revival sends a new task, and at
    full width they piled up until the host ran out of memory (ROADMAP
    C4). ``end`` (stop or disconnect) wins over a waiting task."""

    def __init__(self):
        self._cond = threading.Condition()
        self._task: Any = None
        self._end: Any = None
        self.skipped = 0

    def put(self, task: Any) -> None:
        with self._cond:
            if self._task is not None:
                self.skipped += 1
            self._task = task
            self._cond.notify()

    def end(self, why: Any) -> None:
        with self._cond:
            if self._end is None:
                self._end = why
            self._cond.notify()

    def get(self) -> Any:
        with self._cond:
            while self._task is None and self._end is None:
                self._cond.wait()
            if self._end is not None:
                if self._task is not None:
                    self.skipped += 1
                    self._task = None
                return self._end
            task, self._task = self._task, None
            return task


def _setup(assign: Dict[str, Any]):
    """The child's immutable run state from the assigned ``RunConfig``: its
    device (no fallback), the parent's torch settings, the model, the
    language specs and, under int8, the packing layout (from the leaves'
    shapes, as the server's is), all deterministic in the config."""
    from repro_torch.core import packing
    from repro_torch.data.synthetic import make_language_specs
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import build_model
    device = resolve_device(assign["device"])
    apply_torch_settings(assign["torch"])
    cfg = assign["cfg"]
    model = build_model(cfg.model)
    specs = make_language_specs(cfg.model.vocab_size,
                                n_langs=max(cfg.n_workers, 2), seed=cfg.seed)
    layout = (packing.build_layout(model.param_specs())
              if cfg.outer.compression == "int8" else None)
    return device, model, specs, layout


def _worker_main(address: Tuple[str, Any], nonce: str) -> None:
    """Worker process entry (top level: spawn imports this module).

    Rendezvous, then the run state from the assigned ``RunConfig``
    (``_setup``), then a loop: run each ``RoundTask`` frame with the shared
    ``execute_round`` on the child's device and deliver its result through
    the shared ``ReliableSender``, behind child-side ``FaultyTransport``
    wrappers when the run injects faults (stream 0 data, stream 1
    heartbeats: the threaded runtime's dice keys, so chaos runs replay).
    At a graceful stop the child reports its fault and protocol counters,
    its rounds and its kernel launches, after its final obs frame when the
    assign frame turns obs on."""
    try:
        client = SocketClient.connect(address,
                                      {"nonce": nonce, "pid": os.getpid()})
    except RendezvousRejected:
        sys.exit(3)
    assign = client.assign
    wid = assign["wid"]
    cfg = assign["cfg"]
    faults = assign["faults"]
    mode = assign.get("mode", "deterministic")
    hb_client = None
    try:
        if assign.get("hb_nonce") is not None:
            hb_client = SocketClient.connect(
                address, {"nonce": assign["hb_nonce"], "pid": os.getpid(),
                          "channel": "hb"})
        device, model, specs, layout = _setup(assign)
    except Exception as e:                               # noqa: BLE001
        try:
            client.send_ctrl("fatal", {"wid": wid, "error": repr(e)})
        finally:
            client.close()
        sys.exit(4)

    from repro_torch import kernels
    from repro_torch.async_engine.runtime import RoundError

    clock = {"t0": None, "scale": assign.get("pace_scale", 0.0)}

    def vnow() -> float:
        t0 = clock["t0"]
        if t0 is None:
            return 0.0
        scale = clock["scale"] if clock["scale"] > 0 else 1.0
        return (time.monotonic() - t0) / scale

    tasks = _TaskSlot()
    waiter = AckWaiter()
    client.on_ack = waiter.put

    def on_task(task, clk):
        clock["t0"], clock["scale"] = clk
        tasks.put(task)

    def on_stop():
        tasks.end(_STOP)
        waiter.close()                   # abandon an in-flight retry loop

    def on_disconnect():
        waiter.close()
        tasks.end(_EOF)

    client.on_task = on_task
    client.on_stop = on_stop
    client.on_disconnect = on_disconnect
    client.start()

    data_tx: Transport = _ChildChannel(client, "data")
    hb_tx: Transport = _ChildChannel(hb_client or client, "hb")
    if faults is not None:
        data_tx = FaultyTransport(data_tx, faults, stream=0, clock=vnow)
        hb_tx = FaultyTransport(hb_tx, faults, stream=1, clock=vnow)
    retries = {"n": 0}
    compute = {"rounds": 0, "compute_s": 0.0}
    obs_every = assign["obs_every"]
    tracer = None
    if assign["obs"]:
        from repro_torch.obs.spans import SpanTracer
        tracer = SpanTracer()

    def ship_obs(final: bool = False) -> None:
        """The spans recorded since the last frame, the wire counters of
        both connections, resends, rounds and compute seconds."""
        if tracer is None:
            return
        wire = dict(client.wire)
        if hb_client is not None:
            for k, v in hb_client.wire.items():
                wire[k] += v
        payload = {
            "wid": wid, "pid": os.getpid(), "final": bool(final),
            "offset": client.clock_offset,
            "metrics": {**wire, "retries": retries["n"], **compute},
            "epoch_offset": tracer._epoch + client.clock_offset,
            "spans": tracer.export_new(),
        }
        try:
            client.send_ctrl("obs", payload)
        except (OSError, TransportClosed):
            pass

    sender = ReliableSender(
        data_tx, spec=faults, tracer=tracer,
        on_retry=lambda env, att: retries.__setitem__("n", retries["n"] + 1))

    last_gen = {"g": 0}
    hb_stop = threading.Event()
    if faults is not None and faults.liveness_enabled and mode == "free":
        def hb_loop():
            seq = 0
            while not hb_stop.wait(faults.heartbeat_interval):
                seq += 1
                try:
                    hb_tx.send(Envelope(wid=wid, generation=last_gen["g"],
                                        seq=seq, kind=KIND_HEARTBEAT,
                                        payload=None,
                                        sent_time=time.monotonic()),
                               timeout=0.01)
                except TransportTimeout:
                    continue
                except TransportClosed:
                    return
        threading.Thread(target=hb_loop, daemon=True).start()

    seq = 0
    while True:
        task = tasks.get()
        if task is _STOP or task is _EOF:
            break
        last_gen["g"] = task.generation
        t0 = time.monotonic()
        try:
            out: Any = execute_round(device_task(task, device), model=model,
                                     cfg=cfg, specs=specs, layout=layout,
                                     tracer=tracer)
        except Exception as e:                           # noqa: BLE001
            out = RoundError(task.wid, task.generation, task.round_seq,
                             repr(e))
        compute["rounds"] += 1
        compute["compute_s"] += time.monotonic() - t0
        if task.sleep_per_step > 0 and not isinstance(out, RoundError):
            rest = (task.h_steps * task.sleep_per_step
                    - (time.monotonic() - t0))
            if rest > 0:
                time.sleep(rest)
        seq += 1
        if isinstance(out, RoundError):
            env = Envelope(wid=wid, generation=task.generation, seq=seq,
                           kind=KIND_ERROR, payload=out)
        else:
            # to the host once: the checksum and the frame read these bytes
            out = host_result(out)
            env = Envelope(wid=wid, generation=task.generation, seq=seq,
                           kind=KIND_RESULT, payload=out,
                           crc=payload_crc(out))
        if not sender.send(env, waiter):
            break                                # channel torn down
        if compute["rounds"] % obs_every == 0:
            ship_obs()
    hb_stop.set()
    ship_obs(final=True)
    stats: Dict[str, Any] = {
        "protocol": {"retries": retries["n"],
                     "stale_tasks_skipped": tasks.skipped},
        "rounds": compute["rounds"],
        "launches": {k: v for k, v in kernels.launch_counts().items() if v}}
    if isinstance(data_tx, FaultyTransport):
        stats["data"] = dict(data_tx.counters)
        stats["heartbeat"] = dict(hb_tx.counters)
    try:
        client.send_ctrl("stats", stats)
    except (OSError, TransportClosed):
        pass
    client.close()
    if hb_client is not None:
        hb_client.close()
