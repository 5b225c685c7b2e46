"""Typed schema of the telemetry stream.

A copy of ``repro/telemetry/schema.py`` (the same kinds, fields and
``SCHEMA_VERSION``), so a stream of the port decodes with the reference's
``StreamDecoder`` and the same record gives the same JSON line in both.

A stream is a JSONL file: one ``{"kind": ..., ...}`` object per line.
Seven record kinds:

  meta      one per stream (first line): what produced it;
  arrival   one per committed outer step: scheduling facts (worker,
            staleness, rho, sim/wall time, language/mixture, dropped)
            plus the update-quality stats of ``repro_torch.telemetry.stats``;
  eval      one per evaluation: mean + per-language validation loss;
  fault     one per delivery-protocol event on the wall-clock runtime
            (checksum reject, dedup, quarantine, liveness transition) and
            one end-of-run "summary" carrying the delivery counters;
  runtime   one periodic runtime-health snapshot (engine-driven cadence):
            occupancy, parallelism, queue depth, worker liveness, and the
            delivery/fault counters — the live operator console's
            (the reference's ``python -m repro.obs console``) health panel;
  transport one per child-worker observability report under the socket
            transport (low-rate ``("ctrl","obs",...)`` frames, see
            docs/observability.md): per-worker wire counters (frames and
            bytes each way, serialize/deserialize time, CRC rejects,
            retries, credit-wait stall) + per-round compute wall time,
            pid-stamped so the panels can tell incarnations apart;
  flush     one per server commit-buffer flush (the ``Synchronizer``'s):
            buffered depth at flush, the reason the buffer flushed
            (batch-full / eval / ckpt / close), and how many commits went
            through the fused multi-arrival kernel vs the sequential
            fallback.

Records are frozen dataclasses; ``to_json_line``/``from_json_line``
round-trip them. Unknown keys in a line are rejected loudly (schema
drift should fail, not silently drop fields); bump SCHEMA_VERSION on
breaking changes. Live readers that must survive streams written by a
NEWER schema (the console tailing a file from a newer build) go through
``StreamDecoder``, which tolerates unknown kinds/fields but *counts and
reports* everything it skipped instead of silently thinning the stream.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

# v2: added the "fault" record kind (delivery-robustness events)
# v3: added the "runtime" record kind (periodic runtime-health snapshots)
# v4: added the "transport" record kind (child-worker wire/compute
#     counters shipped over the socket control channel) and the "flush"
#     record kind (commit-buffer depth/reason/fusion metrics)
SCHEMA_VERSION = 4


@dataclass(frozen=True)
class RunMeta:
    """Provenance of one stream."""
    method: str
    engine: str                       # make_engine dialect: "sim"|"wallclock"
    n_workers: int
    outer_steps: int
    seed: int
    non_iid: bool = False
    mixture_alpha: Optional[float] = None
    scenario: str = ""                # scenario / cell name, if any
    schema_version: int = SCHEMA_VERSION


@dataclass(frozen=True)
class ArrivalMetrics:
    """One committed outer step (one pseudo-gradient arrival or one
    synchronous barrier round)."""
    outer_step: int
    worker_id: int
    staleness: int
    rho: float
    sim_time: float
    wall_time: float
    lang: str
    dropped: bool
    # update-quality stats (None when the synchronizer ran stats-free)
    cos_align: Optional[float] = None
    corrected_frac: Optional[float] = None
    delta_norm: Optional[float] = None
    momentum_norm: Optional[float] = None
    # data heterogeneity context
    mixture: Optional[Tuple[float, ...]] = None
    # budget accounting view: cumulative tokens at commit
    tokens_total: int = 0


@dataclass(frozen=True)
class EvalMetrics:
    """One evaluation snapshot (Fig. 2/3 protocol)."""
    outer_step: int
    sim_time: float
    wall_time: float
    mean_loss: float
    per_lang: Dict[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class FaultMetrics:
    """One delivery-protocol event (wall-clock runtime under an
    unreliable channel — see docs/faults.md). ``event`` vocabulary:
    checksum_reject | dedup | quarantine | liveness_dead |
    liveness_revive | summary. Frame identity fields are -1 when the
    event is not tied to a specific frame; ``detail`` carries the
    delivery counters for the end-of-run "summary" event."""
    event: str
    wall_time: float
    wid: int = -1
    seq: int = -1
    generation: int = -1
    detail: Optional[Dict[str, float]] = None


@dataclass(frozen=True)
class RuntimeMetrics:
    """One periodic runtime-health snapshot (engine-driven cadence — the
    ``runtime_record_every`` knob of ``make_engine`` / the
    ``telemetry_every`` field of a Scenario). The wall-clock runtime
    fills every field from its live counters
    (``ConcurrentRuntime.stats_summary()`` / ``delivery_stats()``); the
    simulator emits only the worker-membership view (rates/occupancy
    stay 0). ``liveness`` holds state tallies (``dead``, ``quarantined``,
    ``threads_alive``); ``delivery`` the cumulative delivery/fault
    counters of docs/faults.md."""
    outer_step: int
    sim_time: float
    wall_time: float
    workers_alive: int
    workers_total: int
    in_flight: int = 0
    arrivals: int = 0
    arrivals_per_sec: float = 0.0
    server_occupancy: float = 0.0
    compute_parallelism: float = 0.0
    queue_depth: int = 0
    liveness: Dict[str, int] = field(default_factory=dict)
    delivery: Dict[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class TransportMetrics:
    """One child-worker observability report (socket transport only).

    Children ship these as low-rate ``("ctrl","obs",...)`` frames over
    the same length-prefixed socket the data plane uses; the parent
    stamps its own wall clock and re-emits them into the stream. Time
    fields are cumulative seconds since the worker connected; counters
    are cumulative over the same window, so panels difference
    consecutive records per (wid, pid) for rates. ``final`` marks the
    graceful end-of-run report (the launcher's child-report-in check
    keys on it)."""
    wid: int
    pid: int
    wall_time: float
    frames_sent: int = 0
    frames_recv: int = 0
    bytes_sent: int = 0
    bytes_recv: int = 0
    ser_s: float = 0.0                # pickle serialize wall time
    deser_s: float = 0.0              # unpickle wall time
    crc_rejects: int = 0
    retries: int = 0
    credit_wait_s: float = 0.0        # stalled waiting for send credit
    rounds: int = 0
    compute_s: float = 0.0            # execute_round wall time
    clock_offset_s: float = 0.0       # child->parent clock offset estimate
    final: bool = False


@dataclass(frozen=True)
class FlushMetrics:
    """One server commit-buffer flush (docs/scale.md). ``reason``
    vocabulary: batch-full | eval | ckpt | close. ``fused`` counts
    commits applied through the K-stacked multi-arrival kernels,
    ``sequential`` the per-arrival fallback (drops, non-batchable
    methods, singleton runs)."""
    outer_step: int
    sim_time: float
    wall_time: float
    depth: int
    reason: str
    fused: int = 0
    sequential: int = 0


Record = Union[RunMeta, ArrivalMetrics, EvalMetrics, FaultMetrics,
               RuntimeMetrics, TransportMetrics, FlushMetrics]

KINDS: Dict[str, type] = {"meta": RunMeta, "arrival": ArrivalMetrics,
                          "eval": EvalMetrics, "fault": FaultMetrics,
                          "runtime": RuntimeMetrics,
                          "transport": TransportMetrics,
                          "flush": FlushMetrics}
_KIND_OF = {cls: kind for kind, cls in KINDS.items()}


def kind_of(rec: Record) -> str:
    return _KIND_OF[type(rec)]


def to_json_line(rec: Record) -> str:
    return json.dumps({"kind": kind_of(rec), **dataclasses.asdict(rec)},
                      sort_keys=True)


def from_json_line(line: str) -> Record:
    d = json.loads(line)
    kind = d.pop("kind", None)
    cls = KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown telemetry record kind {kind!r}")
    if cls is ArrivalMetrics and d.get("mixture") is not None:
        d["mixture"] = tuple(d["mixture"])
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"telemetry schema drift: {kind} record has "
                         f"unknown fields {sorted(unknown)}")
    return cls(**d)


class StreamDecoder:
    """Forward-compatible stream reader with drift accounting.

    ``from_json_line`` rejects any unknown key/kind loudly — correct for
    same-version tooling, fatal for a live console tailing a stream a
    NEWER build is writing. The decoder closes that gap with an explicit
    version check instead of silent thinning:

      - it learns the stream's declared version from its ``meta`` record;
      - unknown record kinds and unknown fields are skipped but
        **counted** (``unknown_kinds`` / ``unknown_keys``), and
        ``drift_report()`` renders the tally so a v3 reader *surfaces* a
        v4 stream ("stream schema v4 > reader v3: skipped ...") rather
        than quietly showing less data;
      - ``strict=True`` restores the loud behavior for streams at or
        below the reader's version (genuine drift should still fail) —
        a declared-newer stream is tolerated-and-counted even then.

    Undecodable lines (torn writes that still ended in a newline) are
    never raised in lenient mode; they land in ``bad_lines``.
    """

    def __init__(self, strict: bool = False):
        self.strict = strict
        self.meta: Optional[RunMeta] = None
        self.stream_version: Optional[int] = None
        self.lines = 0
        self.bad_lines = 0
        self.unknown_kinds: Counter = Counter()
        self.unknown_keys: Counter = Counter()

    @property
    def newer_stream(self) -> bool:
        """The stream declared a schema version ahead of this reader."""
        return (self.stream_version is not None
                and self.stream_version > SCHEMA_VERSION)

    def decode(self, line: str) -> Optional[Record]:
        line = line.strip()
        if not line:
            return None
        self.lines += 1
        try:
            d = json.loads(line)
            if not isinstance(d, dict):
                raise ValueError("not an object")
        except ValueError:
            if self.strict and not self.newer_stream:
                raise
            self.bad_lines += 1
            return None
        kind = d.pop("kind", None)
        cls = KINDS.get(kind)
        if cls is None:
            if self.strict and not self.newer_stream:
                raise ValueError(f"unknown telemetry record kind {kind!r}")
            self.unknown_kinds[str(kind)] += 1
            return None
        if cls is ArrivalMetrics and d.get("mixture") is not None:
            d["mixture"] = tuple(d["mixture"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            if self.strict and not self.newer_stream:
                raise ValueError(f"telemetry schema drift: {kind} record "
                                 f"has unknown fields {sorted(unknown)}")
            for k in unknown:
                self.unknown_keys[f"{kind}.{k}"] += 1
                d.pop(k)
        try:
            rec = cls(**d)
        except TypeError:
            # missing required fields (a truncated-then-completed object)
            self.bad_lines += 1
            return None
        if isinstance(rec, RunMeta):
            self.meta = rec
            self.stream_version = int(rec.schema_version)
        return rec

    def drift_report(self) -> List[str]:
        """Human-readable drift/skip tally; empty means a clean stream."""
        out: List[str] = []
        if self.newer_stream:
            out.append(f"stream schema v{self.stream_version} > reader "
                       f"v{SCHEMA_VERSION}: fields/kinds unknown to this "
                       f"reader are skipped (counted below)")
        if self.unknown_kinds:
            tally = ", ".join(f"{k} x{n}" for k, n
                              in sorted(self.unknown_kinds.items()))
            out.append(f"skipped unknown record kinds: {tally}")
        if self.unknown_keys:
            tally = ", ".join(f"{k} x{n}" for k, n
                              in sorted(self.unknown_keys.items()))
            out.append(f"skipped unknown fields: {tally}")
        if self.bad_lines:
            out.append(f"undecodable lines: {self.bad_lines}")
        return out
