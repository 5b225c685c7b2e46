"""Transport for worker -> server pseudo-gradient traffic, and its framing.

Port of ``repro/async_engine/transport.py``. Workers push framed
``Envelope`` messages through a ``Transport`` and the server drains them.
The backend is ``InProcTransport``, a bounded in-process many-producer,
one-consumer channel whose blocking ``send`` gives backpressure: a worker
that outruns the server parks on the channel instead of piling up
pseudo-gradients in memory. ``close`` wakes every blocked producer and
consumer with ``TransportClosed``, which is how the runtime tears its
worker threads down without draining the rounds in flight. Blocking rides
``threading.Condition`` wakeups, so a parked peer does not poll and a
timeout's deadline is exact.

The at-least-once protocol that survives a lossy channel
(``faults.FaultyTransport`` takes reliability away on purpose) is built
from the frame types here:

  ``Envelope``   one framed message: per-worker monotonic ``seq``, worker
                 ``generation``, CRC32 of the payload's bytes, and the
                 retry ``attempt`` (not part of the frame's identity);
  ``Ack``        the server's delivery receipt, routed back on a
                 per-worker side channel; ``ReliableSender`` resends an
                 unacknowledged frame with exponential backoff.

The server deduplicates redeliveries by ``(wid, generation, seq)`` and
rejects frames whose recomputed CRC disagrees with the envelope
(``faults.DeliveryTracker``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from abc import ABC, abstractmethod
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.packing import Packed, leaf_order
from repro_torch.obs.spans import NULL_TRACER


class TransportClosed(Exception):
    """The channel was torn down while a send or recv was in progress."""


class TransportTimeout(Exception):
    """No progress within the caller's timeout."""


class Transport(ABC):
    """One-directional message channel: many producers, one consumer."""

    @abstractmethod
    def send(self, msg: Any, timeout: Optional[float] = None) -> None:
        """Enqueue ``msg``, blocking while the channel is full. Raises
        ``TransportClosed`` if the channel is (or becomes) closed,
        ``TransportTimeout`` after ``timeout`` seconds without room."""

    @abstractmethod
    def recv(self, timeout: Optional[float] = None) -> Any:
        """Dequeue the oldest message. Raises ``TransportClosed`` when
        closed and drained, ``TransportTimeout`` on timeout."""

    @abstractmethod
    def close(self) -> None:
        """Tear the channel down; wakes every blocked sender and receiver."""

    @abstractmethod
    def depth(self) -> int:
        """Messages queued now (approximate under concurrency)."""


class InProcTransport(Transport):
    """Bounded in-process channel. Once ``capacity`` messages are queued,
    producers block in ``send`` until the server drains one; no message is
    ever dropped."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._dq: deque = deque()
        lock = threading.Lock()
        self._not_full = threading.Condition(lock)
        self._not_empty = threading.Condition(lock)
        self._closed = False

    def send(self, msg: Any, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_full:
            while True:
                if self._closed:
                    raise TransportClosed("send on closed transport")
                if len(self._dq) < self.capacity:
                    self._dq.append(msg)
                    self._not_empty.notify()
                    return
                if deadline is None:
                    self._not_full.wait()
                else:
                    rest = deadline - time.monotonic()
                    if rest <= 0:
                        raise TransportTimeout(
                            f"send blocked > {timeout}s "
                            f"(capacity {self.capacity})")
                    self._not_full.wait(rest)

    def recv(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_empty:
            while True:
                if self._dq:
                    msg = self._dq.popleft()
                    self._not_full.notify()
                    return msg
                if self._closed:
                    raise TransportClosed("recv on closed, drained transport")
                if deadline is None:
                    self._not_empty.wait()
                else:
                    rest = deadline - time.monotonic()
                    if rest <= 0:
                        raise TransportTimeout(f"recv idle > {timeout}s")
                    self._not_empty.wait(rest)

    def close(self) -> None:
        with self._not_full:                 # one lock behind both conditions
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def depth(self) -> int:
        return len(self._dq)


# ---------------------------------------------------------------------------
# Delivery framing: envelopes, acks, payload checksums
# ---------------------------------------------------------------------------

# "result" carries a RoundResult (CRC-protected); "error" a RoundError
# (re-raised by the server); "heartbeat" a liveness beacon (no payload, no
# ack)
KIND_RESULT = "result"
KIND_ERROR = "error"
KIND_HEARTBEAT = "heartbeat"


@dataclass(frozen=True)
class Envelope:
    """One framed message. Its identity is ``(wid, generation, seq)``;
    ``attempt`` counts resends of the same frame and is not part of it (the
    fault dice key off it, so a resent frame draws fresh dice)."""
    wid: int
    generation: int
    seq: int
    kind: str
    payload: Any
    crc: int = 0
    attempt: int = 0
    sent_time: float = 0.0           # sender's clock (diagnostics only)


@dataclass(frozen=True)
class Ack:
    """Server -> worker delivery receipt. ``quarantined`` tells the sender
    to stop resending: the server no longer accepts its frames."""
    wid: int
    generation: int
    seq: int
    quarantined: bool = False


def _leaves(delta) -> Iterator[Any]:
    """The leaves of a pseudo-gradient in ``jax.tree.leaves`` order: a
    ``Packed`` buffer is one leaf, a parameter dict its values in
    ``leaf_order``."""
    if isinstance(delta, Packed):
        yield delta.buf
    elif isinstance(delta, dict):
        for path in leaf_order(delta):
            yield from _leaves(delta[path])
    elif isinstance(delta, (list, tuple)):
        for x in delta:
            yield from _leaves(x)
    else:
        yield delta


@dataclass(frozen=True)
class Bf16Bits:
    """A bf16 tensor in host form: its 16-bit patterns (numpy has no
    bf16), as the socket transport ships it."""
    bits: np.ndarray


def host_bytes(leaf) -> memoryview:
    """The leaf's bytes on the host as a flat byte view, without the
    ``tobytes()`` copy: a tensor is copied to the host once (bf16 read as
    its 16-bit pattern, which numpy lacks)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.cpu().numpy()
    elif isinstance(leaf, Bf16Bits):
        arr = leaf.bits
    else:
        arr = np.asarray(leaf)
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def payload_crc(payload: Any) -> int:
    """CRC32 over the pseudo-gradient's host bytes, leaf by leaf in the
    reference's order (``payload.delta``, else ``payload`` itself): what a
    socket backend would checksum on the wire. For bridged bits it equals
    the reference's value. Under int8 compression the delta is a
    ``packing.Packed`` and the packed (R, 128) buffer is hashed, as the
    reference hashes its ``Packed`` pytree's one leaf."""
    crc = 0
    for leaf in _leaves(getattr(payload, "delta", payload)):
        crc = zlib.crc32(host_bytes(leaf), crc)
    return crc


@dataclass
class AckWaiter:
    """The worker half of the retry loop: a Condition-guarded mailbox the
    server drops ``Ack``s into (acks are tiny, per worker, and never apply
    backpressure, so this is no ``Transport``)."""
    _acks: deque = field(default_factory=deque)
    _cond: threading.Condition = field(default_factory=threading.Condition)
    _closed: bool = False

    def put(self, ack: Optional[Ack]) -> None:
        with self._cond:
            if ack is None:
                self._closed = True
            else:
                self._acks.append(ack)
            self._cond.notify_all()

    def wait_for(self, env: Envelope, timeout: float) -> Optional[Ack]:
        """Block until an ack of ``env``'s identity arrives (returned), the
        mailbox closes or ``timeout`` elapses (None either way). Acks of
        earlier frames are discarded."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                while self._acks:
                    ack = self._acks.popleft()
                    if (ack.wid == env.wid
                            and ack.generation == env.generation
                            and ack.seq == env.seq):
                        return ack
                if self._closed:
                    return None
                rest = deadline - time.monotonic()
                if rest <= 0:
                    return None
                self._cond.wait(rest)

    def close(self) -> None:
        self.put(None)

    @property
    def closed(self) -> bool:
        return self._closed


class ReliableSender:
    """The sender half of at-least-once delivery: send the frame, wait for
    the server's receipt, resend with exponential backoff and deterministic
    jitter until it lands. A quarantine ack ends the resends like any other
    ack.

    ``spec``: an optional ``faults.FaultSpec`` with the protocol knobs
    (``ack_timeout``, ``backoff_base``, ``max_backoff``, ``retry_jitter``);
    without one the fault-free defaults apply. ``on_retry`` is called once
    per resend. ``tracer``: an ``obs.spans.SpanTracer`` (None: the shared
    no-op) recording a ``transport.send`` and a ``transport.ack_wait`` span
    per attempt and a ``transport.retry`` instant per resend."""

    #: ack wait on a fault-free channel before a (harmless) resend
    DEFAULT_ACK_TIMEOUT = 5.0

    def __init__(self, transport: Transport, *, spec=None, tracer=None,
                 default_timeout: Optional[float] = None,
                 on_retry: Optional[Callable[[Envelope, int], None]] = None):
        self.transport = transport
        self.spec = spec
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.default_timeout = default_timeout or self.DEFAULT_ACK_TIMEOUT
        self.on_retry = on_retry

    def send(self, env: Envelope, waiter: AckWaiter) -> bool:
        """Deliver ``env`` at least once. False when the channel or the
        ack mailbox is torn down before the receipt lands."""
        spec = self.spec
        base = spec.ack_timeout if spec else self.default_timeout
        boff = spec.backoff_base if spec else 2.0
        cap = spec.max_backoff if spec else self.default_timeout
        attempt = 0
        while True:
            try:
                with self.tracer.span("transport.send", cat="transport",
                                      wid=env.wid, seq=env.seq,
                                      attempt=attempt):
                    self.transport.send(dataclasses.replace(env,
                                                            attempt=attempt))
            except TransportClosed:
                return False
            timeout = min(base * (boff ** attempt), cap)
            if spec is not None:
                timeout *= 1.0 + spec.retry_jitter(env.wid, env.seq, attempt)
            with self.tracer.span("transport.ack_wait", cat="transport",
                                  wid=env.wid, seq=env.seq, attempt=attempt):
                ack = waiter.wait_for(env, timeout)
            if ack is not None:
                return True                  # delivered (or quarantined)
            if waiter.closed:
                return False
            attempt += 1
            self.tracer.instant("transport.retry", cat="transport",
                                wid=env.wid, seq=env.seq, attempt=attempt)
            if self.on_retry is not None:
                self.on_retry(env, attempt)
