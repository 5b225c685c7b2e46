"""In-memory telemetry sink + live JSONL streaming.

A copy of ``repro/telemetry/recorder.py``; the lines it writes are the
reference's, byte for byte, for the same records.

A ``TelemetryRecorder`` is handed to an engine (``make_engine(...,
telemetry=rec)``); the engine emits one ``ArrivalMetrics`` per committed
outer step, one ``EvalMetrics`` per evaluation, and (when a cadence is
configured) periodic ``RuntimeMetrics`` health snapshots. Wall-time
stamps are relative to the recorder's creation, so the stream is
self-contained.

Memory contract
---------------

Two retention modes:

  - **no sink** (default): every record is retained in ``self.records``
    (an unbounded list) — fine for the short CI-sized runs the analyses
    consume, and what ``write_jsonl`` serializes at the end.
  - **live sink** (``TelemetryRecorder(sink=path)``): the full stream
    lives on disk — each record is written and flushed as ONE complete
    JSONL line the moment it is recorded, so a console (the
    reference's ``python -m repro.obs console <path>``) can tail the run
    live. ``self.records`` then
    becomes a bounded ring of the most recent ``window`` records
    (default 4096) so in-process analyses (``summary()``,
    ``arrivals()``, ...) see a recent window while memory stays
    O(window) for arbitrarily long runs. ``write_jsonl`` copies the
    complete on-disk stream, never the ring.

The recorder never influences the run: stats are extra outputs of the
kernels the synchronizer launches anyway, and recording is append-only —
a telemetry-on run launches the same kernels as a telemetry-off run and
ends in the same parameter bits (tests/test_torch_telemetry.py).
"""
from __future__ import annotations

import os
import shutil
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Union

try:                                  # POSIX advisory locks; absent on
    import fcntl                      # exotic platforms -> no enforcement
except ImportError:                   # pragma: no cover
    fcntl = None  # type: ignore[assignment]

from repro_torch.telemetry import schema

#: ring size once a live sink holds the full stream (memory contract above)
DEFAULT_WINDOW = 4096


def _open_exclusive_sink(path: str):
    """Open a live sink with single-writer enforcement.

    Two processes appending interleaved flushes to one JSONL sink can
    tear each other's lines in ways no tail-side reader can repair, so
    the writer side refuses: the sink fd holds an exclusive advisory
    lock (``flock``) for the recorder's lifetime, and a second recorder
    — same process or another one — fails loudly instead of silently
    corrupting the stream. The lock is taken BEFORE truncation so a
    rejected opener never clobbers the live writer's bytes."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    if fcntl is not None:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            raise RuntimeError(
                f"telemetry sink {path!r} already has a live writer "
                f"(single-writer contract: one TelemetryRecorder per "
                f"sink — point the second writer at its own file)")
    os.ftruncate(fd, 0)
    return os.fdopen(fd, "w")


class TelemetryRecorder:
    def __init__(self, meta: Optional[schema.RunMeta] = None,
                 sink: Optional[str] = None,
                 window: Optional[int] = None):
        self.meta = meta
        if sink is not None or window:
            self.records: Union[List[schema.Record], deque] = deque(
                maxlen=window or DEFAULT_WINDOW)
        else:
            self.records = []
        self._t0 = time.perf_counter()
        self._sink_path = sink
        self._sink = None
        self._meta_written = False
        if sink is not None:
            os.makedirs(os.path.dirname(sink) or ".", exist_ok=True)
            self._sink = _open_exclusive_sink(sink)
            self._write_meta_line()

    # ------------------------------------------------------------- emission
    def wall(self) -> float:
        return time.perf_counter() - self._t0

    def _write_meta_line(self) -> None:
        if self._sink is not None and self.meta is not None \
                and not self._meta_written:
            self._sink.write(schema.to_json_line(self.meta) + "\n")
            self._sink.flush()
            self._meta_written = True

    def _emit(self, rec: schema.Record) -> None:
        self.records.append(rec)
        if self._sink is not None:
            self._sink.write(schema.to_json_line(rec) + "\n")
            self._sink.flush()               # per-record: tail-able live

    def ensure_meta(self, **kw) -> None:
        """Set the stream provenance once (first engine to run wins)."""
        if self.meta is None:
            self.meta = schema.RunMeta(**kw)
        self._write_meta_line()

    def record_arrival(self, rec, *, mixture=None,
                       tokens_total: int = 0) -> None:
        """``rec`` duck-types ``repro_torch.async_engine.server.ArrivalRecord``
        (the synchronizer attaches the update-quality stats to it)."""
        def pick(name):
            v = getattr(rec, name, None)
            return None if v is None else float(v)

        self._emit(schema.ArrivalMetrics(
            outer_step=int(rec.outer_step),
            worker_id=int(rec.worker_id),
            staleness=int(rec.staleness),
            rho=float(rec.rho),
            sim_time=float(rec.sim_time),
            wall_time=self.wall(),
            lang=rec.lang,
            dropped=bool(rec.dropped),
            cos_align=pick("cos_align"),
            corrected_frac=pick("corrected_frac"),
            delta_norm=pick("delta_norm"),
            momentum_norm=pick("momentum_norm"),
            mixture=None if mixture is None else tuple(float(x)
                                                       for x in mixture),
            tokens_total=int(tokens_total)))

    def record_eval(self, ev: Dict) -> None:
        """``ev`` is the ``make_eval_fn`` result dict."""
        self._emit(schema.EvalMetrics(
            outer_step=int(ev["step"]),
            sim_time=float(ev["time"]),
            wall_time=self.wall(),
            mean_loss=float(ev["mean"]),
            per_lang={k: float(v) for k, v in ev.get("per_lang",
                                                     {}).items()}))

    def record_fault(self, *, event: str, wid: int = -1, seq: int = -1,
                     generation: int = -1, detail=None) -> None:
        """One delivery-protocol event (checksum reject, dedup,
        quarantine, liveness transition, end-of-run counter summary)."""
        self._emit(schema.FaultMetrics(
            event=event, wall_time=self.wall(), wid=int(wid), seq=int(seq),
            generation=int(generation),
            detail=None if detail is None
            else {k: float(v) for k, v in detail.items()}))

    def record_runtime(self, *, outer_step: int, sim_time: float,
                       **kw) -> None:
        """One periodic runtime-health snapshot (engine-driven cadence;
        see ``schema.RuntimeMetrics`` for the field vocabulary)."""
        self._emit(schema.RuntimeMetrics(
            outer_step=int(outer_step), sim_time=float(sim_time),
            wall_time=self.wall(), **kw))

    def record_transport(self, *, wid: int, pid: int, **kw) -> None:
        """One child-worker wire/compute counter report (socket
        transport control channel; see ``schema.TransportMetrics``)."""
        self._emit(schema.TransportMetrics(
            wid=int(wid), pid=int(pid), wall_time=self.wall(), **kw))

    def record_flush(self, *, outer_step: int, sim_time: float,
                     depth: int, reason: str, fused: int = 0,
                     sequential: int = 0) -> None:
        """One commit-buffer flush event (``schema.FlushMetrics``)."""
        self._emit(schema.FlushMetrics(
            outer_step=int(outer_step), sim_time=float(sim_time),
            wall_time=self.wall(), depth=int(depth), reason=str(reason),
            fused=int(fused), sequential=int(sequential)))

    # -------------------------------------------------------------- queries
    def arrivals(self) -> List[schema.ArrivalMetrics]:
        return [r for r in self.records
                if isinstance(r, schema.ArrivalMetrics)]

    def evals(self) -> List[schema.EvalMetrics]:
        return [r for r in self.records if isinstance(r, schema.EvalMetrics)]

    def faults(self) -> List[schema.FaultMetrics]:
        return [r for r in self.records if isinstance(r, schema.FaultMetrics)]

    def runtime_records(self) -> List[schema.RuntimeMetrics]:
        return [r for r in self.records
                if isinstance(r, schema.RuntimeMetrics)]

    def transport_records(self) -> List[schema.TransportMetrics]:
        return [r for r in self.records
                if isinstance(r, schema.TransportMetrics)]

    def flush_records(self) -> List[schema.FlushMetrics]:
        return [r for r in self.records
                if isinstance(r, schema.FlushMetrics)]

    def __len__(self) -> int:
        return len(self.records)

    def summary(self) -> Dict:
        from repro_torch.telemetry import analysis
        return analysis.summarize(self.arrivals(), self.evals())

    # ------------------------------------------------------------------ io
    @property
    def sink_path(self) -> Optional[str]:
        return self._sink_path

    def flush(self) -> None:
        if self._sink is not None:
            self._sink.flush()

    def close(self) -> None:
        """Flush and close the live sink (idempotent; the stream file
        stays valid after every flushed line, so close is a courtesy,
        not a durability requirement)."""
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def write_jsonl(self, path: str) -> str:
        """Persist the FULL stream to ``path``. With a live sink the
        complete stream is already on disk — it is copied (not the
        bounded in-memory ring); without one, the in-memory records are
        serialized."""
        if self._sink_path is not None:
            self.flush()
            if os.path.abspath(path) != os.path.abspath(self._sink_path):
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                shutil.copyfile(self._sink_path, path)
            return path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            if self.meta is not None:
                f.write(schema.to_json_line(self.meta) + "\n")
            for rec in self.records:
                f.write(schema.to_json_line(rec) + "\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def read_jsonl(cls, path: str) -> "TelemetryRecorder":
        rec = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                r = schema.from_json_line(line)
                if isinstance(r, schema.RunMeta):
                    rec.meta = r
                else:
                    rec.records.append(r)
        return rec


def iter_jsonl(path: str) -> Iterator[schema.Record]:
    """Streaming reader (large sweeps)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield schema.from_json_line(line)
