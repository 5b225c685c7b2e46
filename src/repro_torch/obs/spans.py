"""Span tracing of the port's engines as Chrome trace-event JSON: the port
of ``repro/obs/spans.py``.

A ``SpanTracer`` records spans on the hot paths of the engines (worker
rounds, compression, transport sends and ack waits, server commits, evals,
checkpoints) and exports them as Chrome trace-event JSON (the
``traceEvents`` format, loadable in Perfetto or ``chrome://tracing``),
byte for byte the reference's document. Each span records the thread it
ran on; worker processes ship theirs to the parent (``export_new``,
``ingest_remote``), which renders each process as a row of its own.

Cost
----

Tracing never changes what a run computes:

  - disabled (engines hold the shared ``NULL_TRACER``), a span is one
    attribute lookup and one call returning a shared no-op context
    manager: no allocation, no clock read, no CUDA event, no synchronise;
  - enabled, a span is two ``perf_counter`` reads and one list append
    (atomic under the GIL, so threads record without a lock); JSON is
    encoded once, at ``write``.

The card
--------

On a CUDA device torch returns before the work it queued has run, so a
host span around a worker round would time its enqueue. When the tracer
is enabled, a span of a category that names device work (``DEVICE_CATS``:
compute, server, eval, ckpt) ends only once an event recorded on the
current stream at its exit has completed (``torch.cuda.Event.synchronize``):
its duration covers the device work queued up to its end, including work
queued before it began that had not run yet. Transport and engine spans
stay host spans. Where torch is not loaded or CUDA not initialised (a CPU
run), no event is made. On the threaded runtime every worker and the
server share the device's default stream, so there a span's end also waits
for work other threads queued before it, and a worker round's span can
include a commit's kernels.

    tracer = SpanTracer()
    with tracer.span("worker_round", cat="compute", wid=3):
        ...
    tracer.write("build/run.trace.json")
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["SpanTracer", "NullTracer", "NULL_TRACER", "DEVICE_CATS",
           "validate_chrome_trace"]

#: span categories whose body queues device work: on a card, such a span
#: ends when that work has run
DEVICE_CATS = frozenset({"compute", "server", "eval", "ckpt"})


def _device_fence() -> None:
    """Wait until the work queued so far on the current CUDA stream has
    run; nothing where torch is not loaded or CUDA not initialised."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()


class _Span:
    """One live span; created by ``SpanTracer.span`` and finished by the
    ``with`` exit. Re-entrant use is not supported (make a new one)."""
    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tr: "SpanTracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._cat in DEVICE_CATS:
            _device_fence()
        t1 = time.perf_counter()
        tr = self._tr
        ident = threading.get_ident()
        if ident not in tr._names:               # first span on this thread
            tr._names[ident] = threading.current_thread().name
        tr._events.append((self._name, self._cat, "X",
                           self._t0 - tr._epoch, t1 - self._t0,
                           ident, self._args))
        return None


class _NullSpan:
    """Shared no-op context manager (the disabled-tracer fast path)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracing disabled: every call is a no-op. Engines default to the
    shared ``NULL_TRACER`` so instrumentation sites stay unconditional."""
    enabled = False

    def span(self, name: str, cat: str = "engine", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "engine", **args) -> None:
        return None

    def write(self, path: str) -> str:          # pragma: no cover - guard
        raise RuntimeError("NULL_TRACER records nothing; build a "
                           "SpanTracer to export a trace")

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()


class SpanTracer:
    """Collects spans from any thread; exports Chrome trace-event JSON."""
    enabled = True

    def __init__(self):
        self._epoch = time.perf_counter()
        # (name, cat, ph, start_s, dur_s, tid, args) tuples; list.append
        # is GIL-atomic so worker threads record lock-free
        self._events: List[tuple] = []
        # thread ident -> name, captured at record time (worker threads
        # are usually joined before export)
        self._names: Dict[int, str] = {}
        # high-water mark for export_new (cross-process shipping)
        self._exported = 0
        # pid -> {"name", "epoch_offset", "events", "names"} merged rows
        # from child processes (ingest_remote)
        self._foreign: Dict[int, Dict[str, Any]] = {}

    # ------------------------------------------------------------ recording
    def span(self, name: str, cat: str = "engine", **args) -> _Span:
        """Context manager timing one span (ph="X" complete event)."""
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "engine", **args) -> None:
        """Zero-duration marker (ph="i"): retries, drops, state flips."""
        ident = threading.get_ident()
        if ident not in self._names:
            self._names[ident] = threading.current_thread().name
        self._events.append((name, cat, "i",
                             time.perf_counter() - self._epoch, 0.0,
                             ident, args or None))

    def __len__(self) -> int:
        return len(self._events) + sum(len(f["events"])
                                       for f in self._foreign.values())

    # --------------------------------------------- cross-process shipping
    def export_new(self) -> Dict[str, Any]:
        """Child side: the events recorded since the last export, as a
        picklable payload (list-of-lists + the thread-name map). Times
        stay in the child's clock: the parent re-bases them at ingest
        with the rendezvous ``epoch_offset``. Incremental: each call
        ships only the new tail, so low-rate periodic frames stay small.
        The slice ends at a high-water mark read once, so spans that
        other threads append meanwhile go in the next batch."""
        n = len(self._events)
        evs = [list(e) for e in self._events[self._exported:n]]
        self._exported = n
        return {"events": evs, "names": dict(self._names)}

    def ingest_remote(self, *, pid: int, epoch_offset: float,
                      events: List[list], names: Dict[int, str],
                      process_name: Optional[str] = None) -> None:
        """Parent side: merge a child's exported span batch as a
        distinct process row. ``epoch_offset`` maps a child-relative
        start time into the parent's ``perf_counter`` clock
        (``child_epoch + clock_offset``, both estimated at rendezvous);
        ``to_chrome`` then renders every process against the one parent
        epoch so the Perfetto timeline lines up."""
        entry = self._foreign.setdefault(
            int(pid), {"name": process_name or f"heloco-proc-{pid}",
                       "epoch_offset": float(epoch_offset),
                       "events": [], "names": {}})
        if process_name:
            entry["name"] = process_name
        entry["epoch_offset"] = float(epoch_offset)
        entry["events"].extend(tuple(e) for e in events)
        entry["names"].update({int(k): str(v) for k, v in names.items()})

    @property
    def pids(self) -> List[int]:
        """Process rows the merged trace will contain (0 = this one)."""
        return [0] + sorted(self._foreign)

    # -------------------------------------------------------------- export
    def to_chrome(self) -> Dict[str, Any]:
        """The trace-event JSON object format: ``{"traceEvents": [...]}``
        with per-thread ``thread_name`` metadata. Timestamps are
        microseconds since the tracer's creation."""
        # map python thread idents to small stable tids + their names
        # (record-time capture first; live threads fill any gaps)
        tids: Dict[int, int] = {}
        names: Dict[int, str] = dict(self._names)
        for th in threading.enumerate():
            names.setdefault(th.ident, th.name)
        events: List[Dict[str, Any]] = []
        for name, cat, ph, start, dur, ident, args in list(self._events):
            tid = tids.setdefault(ident, len(tids))
            ev: Dict[str, Any] = {
                "name": name, "cat": cat or "engine", "ph": ph,
                "ts": round(start * 1e6, 3), "pid": 0, "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"                    # thread-scoped instant
            if args:
                ev["args"] = args
            events.append(ev)
        meta = [{"name": "process_name", "ph": "M", "pid": 0,
                 "args": {"name": "heloco-runtime"}}]
        for ident, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid,
                         "args": {"name": names.get(ident,
                                                    f"thread-{tid}")}})
        # child-process rows: timestamps re-based into the parent epoch
        # via each child's rendezvous-estimated epoch_offset; clamped at
        # 0 so clock-estimate jitter can't render a negative ts
        for pid in sorted(self._foreign):
            entry = self._foreign[pid]
            base = entry["epoch_offset"] - self._epoch
            ctids: Dict[int, int] = {}
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "args": {"name": entry["name"]}})
            for name, cat, ph, start, dur, ident, args in entry["events"]:
                tid = ctids.setdefault(ident, len(ctids))
                ev = {"name": name, "cat": cat or "engine", "ph": ph,
                      "ts": round(max(0.0, start + base) * 1e6, 3),
                      "pid": pid, "tid": tid}
                if ph == "X":
                    ev["dur"] = round(dur * 1e6, 3)
                if ph == "i":
                    ev["s"] = "t"
                if args:
                    ev["args"] = args
                events.append(ev)
            for ident, tid in sorted(ctids.items(), key=lambda kv: kv[1]):
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid,
                             "args": {"name": entry["names"].get(
                                 ident, f"thread-{tid}")}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# Validation (`python -m repro_torch.obs trace --validate`)
# ---------------------------------------------------------------------------

_REQUIRED = {"name", "ph", "ts", "pid", "tid"}


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural well-formedness of a trace-event JSON document (what
    Perfetto's legacy JSON importer requires). Returns a list of
    problems; empty means loadable."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["not a trace-event JSON object (missing 'traceEvents')"]
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["'traceEvents' must be a non-empty list"]
    n_spans = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event[{i}] is not an object")
            continue
        if ev.get("ph") == "M":
            continue                             # metadata: name/args only
        missing = _REQUIRED - set(ev)
        if missing:
            problems.append(f"event[{i}] missing keys {sorted(missing)}")
            continue
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            problems.append(f"event[{i}] bad ts {ev['ts']!r}")
        if ev["ph"] == "X":
            n_spans += 1
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                problems.append(f"event[{i}] complete event without a "
                                f"non-negative 'dur'")
        if len(problems) > 20:
            problems.append("... (truncated)")
            break
    if n_spans == 0:
        problems.append("no complete ('X') span events recorded")
    return problems
