"""Specs of an unreliable delivery layer, as data.

A copy of the frozen ``PartitionSpec`` / ``FaultSpec`` dataclasses of
``repro/async_engine/faults.py`` with their JSON form, so that the port's
scenario registry holds the reference's chaos scenarios field for field.
It also holds the reference's splitmix64 dice (``_splitmix64``, ``_unit``),
bit for bit on Python ints, which the gossip topology's peer sampling
(``topology.py``) rolls. The port has no wall-clock runtime yet: the fault
injector, the delivery tracker and the fault decisions wait for it
(ROADMAP A13), and a scenario that sets ``faults`` raises when it is built.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

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
