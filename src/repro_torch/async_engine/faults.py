"""Deterministic fault injection and the server's at-least-once
bookkeeping: the port of ``repro/async_engine/faults.py``.

  ``FaultSpec``         a frozen, seeded description of channel pathology
                        (drop, duplicate, reorder, delay, corrupt, ack loss,
                        partition windows) and of the detection policy
                        (heartbeat cadence, liveness misses, quarantine
                        threshold, retry timeouts); ``Scenario.faults``.
  ``FaultyTransport``   wraps any inner ``Transport`` and injects those
                        faults deterministically: every decision is a pure
                        function of ``(seed, stream, wid, seq, attempt)``,
                        so a chaos run replays however threads interleave,
                        and a resent frame draws fresh dice.
  ``DeliveryTracker``   the receiving half of at-least-once delivery: CRC
                        verification, ``(wid, generation, seq)`` dedup of
                        redeliveries, quarantine after consecutive corrupt
                        frames, and the delivery counters.

The splitmix64 dice (``_splitmix64``, ``_unit``) are the reference's bit for
bit on Python ints; the gossip topology's peer sampling (``topology.py``)
rolls them too. With resends and dedup, the committed history of a
deterministic-mode run under any eventually-delivering fault pattern is its
fault-free twin's: only latency and the delivery counters move.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.async_engine.transport import (
    Envelope, KIND_RESULT, Transport, payload_crc,
)

# ---------------------------------------------------------------------------
# Deterministic per-message dice: splitmix64 over a mixed key
# ---------------------------------------------------------------------------

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _unit(seed: int, *key: int) -> float:
    """Deterministic uniform [0, 1) from an integer key: a pure function of
    the key, never of call order."""
    x = seed & _MASK
    for k in key:
        x = _splitmix64(x ^ (k & _MASK))
    return x / float(1 << 64)


# stream salts: independent dice per fault type and channel
_S_DROP, _S_DUP, _S_REORDER, _S_DELAY, _S_CORRUPT, _S_ACK, _S_JITTER = \
    range(1, 8)


@dataclass(frozen=True)
class PartitionSpec:
    """A network partition window on the scenario's virtual clock: frames
    (data and heartbeats) from ``wids`` are black-holed while ``start <= t <
    end``. Empty ``wids`` partitions every worker."""
    start: float
    end: float
    wids: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.end > self.start >= 0.0:
            raise ValueError(f"bad partition window {(self.start, self.end)}")

    def covers(self, wid: int, t: float) -> bool:
        return (self.start <= t < self.end
                and (not self.wids or wid in self.wids))


@dataclass(frozen=True)
class FaultSpec:
    """Seeded description of an unreliable delivery layer: per-frame drop,
    duplicate, reorder, delay, corrupt and ack-loss probabilities, partition
    windows, and the retry / heartbeat / liveness / quarantine policy knobs
    of the reference's runtime (see its docstring for each)."""
    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    delay_p: float = 0.0
    delay_s: float = 0.0
    corrupt_p: float = 0.0
    ack_drop_p: float = 0.0
    corrupt_wids: Optional[Tuple[int, ...]] = None
    partitions: Tuple[PartitionSpec, ...] = ()
    seed: int = 0
    # protocol / policy
    ack_timeout: float = 0.25
    backoff_base: float = 2.0
    max_backoff: float = 2.0
    heartbeat_interval: float = 0.0
    liveness_misses: int = 3
    quarantine_after: int = 8

    def __post_init__(self):
        for name in ("drop_p", "dup_p", "reorder_p", "delay_p",
                     "corrupt_p", "ack_drop_p"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} is not a probability")
        if not (self.ack_timeout > 0 and self.backoff_base >= 1.0
                and self.quarantine_after >= 1 and self.liveness_misses >= 1):
            raise ValueError("bad retry / liveness / quarantine policy")

    # ------------------------------------------------------------- decisions
    def drops(self, wid: int, seq: int, attempt: int) -> bool:
        return _unit(self.seed, _S_DROP, wid, seq, attempt) < self.drop_p

    def duplicates(self, wid: int, seq: int, attempt: int) -> bool:
        return _unit(self.seed, _S_DUP, wid, seq, attempt) < self.dup_p

    def reorders(self, wid: int, seq: int, attempt: int) -> bool:
        return _unit(self.seed, _S_REORDER, wid, seq, attempt) < self.reorder_p

    def delays(self, wid: int, seq: int, attempt: int) -> bool:
        return _unit(self.seed, _S_DELAY, wid, seq, attempt) < self.delay_p

    def corrupts(self, wid: int, seq: int, attempt: int) -> bool:
        if self.corrupt_wids is not None and wid not in self.corrupt_wids:
            return False
        return _unit(self.seed, _S_CORRUPT, wid, seq, attempt) < self.corrupt_p

    def drops_ack(self, wid: int, seq: int, attempt: int) -> bool:
        return _unit(self.seed, _S_ACK, wid, seq, attempt) < self.ack_drop_p

    def retry_jitter(self, wid: int, seq: int, attempt: int) -> float:
        """Deterministic jitter fraction in [0, 0.25): desynchronizes
        resend storms and still replays."""
        return 0.25 * _unit(self.seed, _S_JITTER, wid, seq, attempt)

    def in_partition(self, wid: int, t: float) -> bool:
        return any(p.covers(wid, t) for p in self.partitions)

    @property
    def liveness_enabled(self) -> bool:
        return self.heartbeat_interval > 0

    # ------------------------------------------------------------------ json

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        d = dict(d)
        if d.get("corrupt_wids") is not None:
            d["corrupt_wids"] = tuple(d["corrupt_wids"])
        parts = []
        for p in d.get("partitions", ()):
            p = dict(p)
            p["wids"] = tuple(p.get("wids", ()))
            parts.append(PartitionSpec(**p))
        d["partitions"] = tuple(parts)
        return cls(**d)


# ---------------------------------------------------------------------------
# The faulty channel
# ---------------------------------------------------------------------------

class FaultyTransport(Transport):
    """Deterministic fault injector around any inner ``Transport``.

    Only ``Envelope`` traffic is faulted (the dice key off the frame's
    identity); any other message passes untouched. Corruption flips the
    envelope's CRC on a copy, so the sender's frame stays pristine and a
    resend carries a clean checksum. Reordering shelves a frame and
    releases it after the next one passes (an adjacent swap); ``close``
    flushes the shelf. ``clock`` maps wall time to the scenario's virtual
    clock for partition windows (required when the spec has any)."""

    def __init__(self, inner: Transport, spec: FaultSpec, *,
                 stream: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        if spec.partitions and clock is None:
            raise ValueError("partition windows need a virtual clock "
                             "(free-running runtime only)")
        self.inner = inner
        self.spec = spec
        self.stream = stream             # salt: data or heartbeat channel
        self.clock = clock
        self._shelf: Optional[Envelope] = None
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "injected_drops": 0, "injected_dups": 0, "injected_reorders": 0,
            "injected_delays": 0, "injected_corruptions": 0,
            "partition_drops": 0,
        }

    def send(self, msg: Any, timeout: Optional[float] = None) -> None:
        if not isinstance(msg, Envelope):
            self.inner.send(msg, timeout=timeout)
            return
        key = (msg.wid, msg.seq + (self.stream << 40), msg.attempt)
        spec = self.spec
        if spec.partitions and spec.in_partition(msg.wid, self.clock()):
            self._count("partition_drops")
            return
        if spec.drops(*key):
            self._count("injected_drops")
            return
        if msg.kind == KIND_RESULT and spec.corrupts(*key):
            self._count("injected_corruptions")
            msg = dataclasses.replace(msg, crc=msg.crc ^ 0xDEADBEEF)
        if spec.delays(*key) and spec.delay_s > 0:
            self._count("injected_delays")
            time.sleep(spec.delay_s)
        copies = 1
        if spec.duplicates(*key):
            self._count("injected_dups")
            copies = 2
        for _ in range(copies):
            self._send_with_shelf(msg, key, timeout)

    def _send_with_shelf(self, msg: Envelope, key, timeout):
        """Adjacent-swap reordering: a shelved frame goes out right after
        the next frame."""
        with self._lock:
            held, self._shelf = self._shelf, None
            if held is None and self.spec.reorders(*key):
                self.counters["injected_reorders"] += 1
                self._shelf = msg
                return
        self.inner.send(msg, timeout=timeout)
        if held is not None:
            self.inner.send(held, timeout=timeout)

    def recv(self, timeout: Optional[float] = None) -> Any:
        return self.inner.recv(timeout=timeout)

    def close(self) -> None:
        # flush the shelf so no frame is silently lost at teardown
        with self._lock:
            held, self._shelf = self._shelf, None
        if held is not None:
            try:
                self.inner.send(held, timeout=0.1)
            except Exception:                      # noqa: BLE001 (teardown)
                pass
        self.inner.close()

    def depth(self) -> int:
        return self.inner.depth()

    def _count(self, key: str):
        with self._lock:
            self.counters[key] += 1


# ---------------------------------------------------------------------------
# The receiver's at-least-once bookkeeping
# ---------------------------------------------------------------------------

#: delivery-health counter names, in reporting order
DELIVERY_COUNTERS = (
    "retries", "redelivered_deduped", "checksum_rejects", "acks_dropped",
    "quarantines", "heartbeat_misses", "liveness_deaths",
    "liveness_revivals",
)


@dataclass
class Verdict:
    """``DeliveryTracker``'s decision on one received frame."""
    status: str                      # "accept" | "dup" | "reject"
    ack: bool                        # send a delivery receipt
    quarantine: bool = False         # this frame crossed the threshold


class DeliveryTracker:
    """The server's half of at-least-once delivery.

    - verifies the payload CRC of every result frame and rejects a
      mismatch (never acked, so the sender resends, and a new attempt
      rolls the corruption dice afresh);
    - deduplicates redeliveries by ``(wid, generation, seq)``: a worker has
      one frame in flight at a time, so a high-water mark per stream will
      do;
    - quarantines a worker after ``quarantine_after`` consecutive corrupt
      frames: its frames are then acked with the quarantine flag (the
      sender stops) and discarded."""

    def __init__(self, quarantine_after: int = 8):
        self.quarantine_after = quarantine_after
        self._high_water: Dict[int, Tuple[int, int]] = {}  # wid->(gen,seq)
        self._consec_bad: Dict[int, int] = {}
        self.quarantined: set = set()
        self.counters: Dict[str, int] = {k: 0 for k in DELIVERY_COUNTERS}

    def reset_stream(self, wid: int) -> None:
        """A (re)started worker thread begins a fresh seq stream."""
        self._high_water.pop(wid, None)
        self._consec_bad.pop(wid, None)

    def process(self, env: Envelope) -> Verdict:
        wid = env.wid
        if wid in self.quarantined:
            return Verdict("reject", ack=True, quarantine=True)
        if env.kind == KIND_RESULT and payload_crc(env.payload) != env.crc:
            self.counters["checksum_rejects"] += 1
            bad = self._consec_bad.get(wid, 0) + 1
            self._consec_bad[wid] = bad
            if bad >= self.quarantine_after:
                self.counters["quarantines"] += 1
                self.quarantined.add(wid)
                return Verdict("reject", ack=True, quarantine=True)
            return Verdict("reject", ack=False)
        self._consec_bad[wid] = 0
        hw = self._high_water.get(wid)
        if hw is not None and (env.generation, env.seq) <= hw:
            self.counters["redelivered_deduped"] += 1
            return Verdict("dup", ack=True)
        self._high_water[wid] = (env.generation, env.seq)
        return Verdict("accept", ack=True)
