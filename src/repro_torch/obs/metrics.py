"""One rollup of a telemetry JSONL stream for every observability view:
the port of ``repro/obs/metrics.py``.

``MetricsAggregator`` feeds the terminal console (``obs.console`` renders
its panels), the web dashboard and its SSE feed (``obs.web``) and the
headless JSON snapshot (``python -m repro_torch.obs web --snapshot``). It
ingests records decoded by ``repro_torch.telemetry.schema``'s
``StreamDecoder`` (which absorbs schema drift) and exposes ``panels()``: a
plain-JSON dict of named panels (arrival rate, staleness histogram,
update-quality window, per-language loss, worker liveness, runtime
health, delivery and chaos counters, the worker processes' transport
counters, commit-buffer flushes, schema drift). Frontends format; this
module computes the numbers all three show.
"""
from __future__ import annotations

from collections import Counter, deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.telemetry import schema

__all__ = ["MetricsAggregator"]


class MetricsAggregator:
    """Streaming aggregator: feed lines (or records), read ``panels()``.

    Windowed quantities (arrival rate, cos/corrected-mass sparklines)
    keep the last ``window`` samples; counters and histograms are
    whole-stream. Transport records are CUMULATIVE per (wid, pid) — the
    latest snapshot wins, and totals sum the latest snapshot of every
    incarnation seen.
    """

    def __init__(self, window: int = 256, strict: bool = False):
        self.decoder = schema.StreamDecoder(strict=strict)
        self.window = window
        self.meta: Optional[schema.RunMeta] = None
        # arrivals
        self.n_arrivals = 0
        self.n_dropped = 0
        self.tokens_total = 0
        self.outer_step = 0
        self.last_wall = 0.0
        self.staleness: Counter = Counter()
        self.cos = deque(maxlen=window)
        self.corr = deque(maxlen=window)
        self.recent_wall = deque(maxlen=window)   # commit stamps, for rate
        # per-worker view
        self.workers: Dict[int, Dict] = {}
        # evals / faults / runtime
        self.last_eval: Optional[schema.EvalMetrics] = None
        self.fault_counts: Counter = Counter()
        self.delivery: Dict[str, float] = {}
        self.last_runtime: Optional[schema.RuntimeMetrics] = None
        # cross-process transport: (wid, pid) -> latest cumulative record
        self.transport: Dict[Tuple[int, int], schema.TransportMetrics] = {}
        # commit-buffer flushes
        self.n_flushes = 0
        self.flush_reasons: Counter = Counter()
        self.flush_depths = deque(maxlen=window)
        self.flush_depth_max = 0
        self.flush_fused = 0
        self.flush_sequential = 0

    # ------------------------------------------------------------ ingestion
    def add_line(self, line: str) -> None:
        rec = self.decoder.decode(line)
        if rec is not None:
            self.add(rec)

    def _worker(self, wid: int) -> Dict:
        return self.workers.setdefault(
            wid, {"arrivals": 0, "last_step": None, "last_wall": None,
                  "state": "alive"})

    def add(self, rec: schema.Record) -> None:
        if isinstance(rec, schema.RunMeta):
            self.meta = rec
        elif isinstance(rec, schema.ArrivalMetrics):
            self.n_arrivals += 1
            self.n_dropped += bool(rec.dropped)
            self.tokens_total = max(self.tokens_total, rec.tokens_total)
            self.outer_step = max(self.outer_step, rec.outer_step)
            self.last_wall = max(self.last_wall, rec.wall_time)
            self.staleness[rec.staleness] += 1
            if rec.cos_align is not None and not rec.dropped:
                self.cos.append(rec.cos_align)
                self.corr.append(rec.corrected_frac or 0.0)
            self.recent_wall.append(rec.wall_time)
            w = self._worker(rec.worker_id)
            w["arrivals"] += 1
            w["last_step"] = rec.outer_step
            w["last_wall"] = rec.wall_time
            if w["state"] == "dead":          # an arrival proves liveness
                w["state"] = "alive"
        elif isinstance(rec, schema.EvalMetrics):
            self.last_eval = rec
            self.last_wall = max(self.last_wall, rec.wall_time)
        elif isinstance(rec, schema.FaultMetrics):
            self.fault_counts[rec.event] += 1
            self.last_wall = max(self.last_wall, rec.wall_time)
            if rec.event == "liveness_dead" and rec.wid >= 0:
                self._worker(rec.wid)["state"] = "dead"
            elif rec.event == "liveness_revive" and rec.wid >= 0:
                self._worker(rec.wid)["state"] = "alive"
            elif rec.event == "quarantine" and rec.wid >= 0:
                self._worker(rec.wid)["state"] = "quarantined"
            elif rec.event == "summary" and rec.detail:
                for k, v in rec.detail.items():
                    self.delivery[k] = max(self.delivery.get(k, 0.0), v)
        elif isinstance(rec, schema.RuntimeMetrics):
            self.last_runtime = rec
            self.last_wall = max(self.last_wall, rec.wall_time)
            for k, v in rec.delivery.items():
                self.delivery[k] = max(self.delivery.get(k, 0.0), v)
        elif isinstance(rec, schema.TransportMetrics):
            # cumulative per incarnation: latest snapshot wins
            self.transport[(rec.wid, rec.pid)] = rec
            self.last_wall = max(self.last_wall, rec.wall_time)
        elif isinstance(rec, schema.FlushMetrics):
            self.n_flushes += 1
            self.flush_reasons[rec.reason] += 1
            self.flush_depths.append(rec.depth)
            self.flush_depth_max = max(self.flush_depth_max, rec.depth)
            self.flush_fused += rec.fused
            self.flush_sequential += rec.sequential
            self.last_wall = max(self.last_wall, rec.wall_time)

    # -------------------------------------------------------------- derived
    def arrival_rate(self) -> float:
        """Commits/sec over the recent window (stream wall-time stamps,
        so replaying a recorded stream shows the recorded rate)."""
        w = list(self.recent_wall)
        if len(w) < 2 or w[-1] <= w[0]:
            return 0.0
        return (len(w) - 1) / (w[-1] - w[0])

    def transport_totals(self) -> Dict[str, float]:
        """Sum the latest cumulative snapshot of every (wid, pid)."""
        tot: Dict[str, float] = {}
        for rec in self.transport.values():
            for k in ("frames_sent", "frames_recv", "bytes_sent",
                      "bytes_recv", "ser_s", "deser_s", "crc_rejects",
                      "retries", "credit_wait_s", "rounds", "compute_s"):
                tot[k] = tot.get(k, 0) + getattr(rec, k)
        return tot

    # --------------------------------------------------------------- panels
    def panels(self) -> Dict[str, Any]:
        """Everything the frontends display, as one plain-JSON dict.
        Panels with nothing to show are present but empty — frontends
        decide whether to hide them."""
        meta = None
        if self.meta is not None:
            m = self.meta
            meta = {"scenario": m.scenario, "method": m.method,
                    "engine": m.engine, "n_workers": m.n_workers,
                    "seed": m.seed, "outer_steps": m.outer_steps,
                    "schema_version": m.schema_version}
        arrivals = {
            "commits": self.n_arrivals, "dropped": self.n_dropped,
            "outer_step": self.outer_step,
            "tokens_total": self.tokens_total,
            "rate_per_sec": self.arrival_rate(),
            "last_wall": self.last_wall,
        }
        staleness = {str(tau): int(n)
                     for tau, n in sorted(self.staleness.items())}
        quality = {}
        if self.cos:
            cos, corr = list(self.cos), list(self.corr)
            quality = {
                "cos": cos, "corr": corr,
                "cos_last": cos[-1], "cos_mean": sum(cos) / len(cos),
                "corr_last": corr[-1], "corr_mean": sum(corr) / len(corr),
            }
        per_language = {}
        if self.last_eval is not None:
            ev = self.last_eval
            per_language = {"outer_step": ev.outer_step,
                            "mean_loss": ev.mean_loss,
                            "per_lang": dict(ev.per_lang or {})}
            if ev.per_lang:
                losses = list(ev.per_lang.values())
                per_language["spread"] = max(losses) - min(losses)
        workers = {
            str(wid): {"arrivals": w["arrivals"], "state": w["state"],
                       "last_step": w["last_step"],
                       "last_wall": w["last_wall"]}
            for wid, w in sorted(self.workers.items())}
        runtime = {}
        if self.last_runtime is not None:
            rt = self.last_runtime
            runtime = {
                "server_occupancy": rt.server_occupancy,
                "compute_parallelism": rt.compute_parallelism,
                "queue_depth": rt.queue_depth,
                "in_flight": rt.in_flight,
                "workers_alive": rt.workers_alive,
                "workers_total": rt.workers_total,
                "liveness": dict(rt.liveness or {}),
            }
        delivery = {
            "counters": {k: v for k, v in sorted(self.delivery.items())
                         if v},
            "events": {k: int(v)
                       for k, v in sorted(self.fault_counts.items())
                       if k != "summary"},
        }
        transport = {}
        if self.transport:
            transport = {
                "workers": {
                    f"{wid}/{pid}": {
                        "frames_sent": rec.frames_sent,
                        "frames_recv": rec.frames_recv,
                        "bytes_sent": rec.bytes_sent,
                        "bytes_recv": rec.bytes_recv,
                        "ser_s": rec.ser_s, "deser_s": rec.deser_s,
                        "crc_rejects": rec.crc_rejects,
                        "retries": rec.retries,
                        "credit_wait_s": rec.credit_wait_s,
                        "rounds": rec.rounds, "compute_s": rec.compute_s,
                        "clock_offset_s": rec.clock_offset_s,
                        "final": rec.final,
                    }
                    for (wid, pid), rec in sorted(self.transport.items())},
                "totals": self.transport_totals(),
            }
        flush = {}
        if self.n_flushes:
            depths = list(self.flush_depths)
            flush = {
                "flushes": self.n_flushes,
                "reasons": {k: int(v)
                            for k, v in sorted(self.flush_reasons.items())},
                "depth_mean": sum(depths) / len(depths),
                "depth_max": self.flush_depth_max,
                "fused": self.flush_fused,
                "sequential": self.flush_sequential,
            }
        return {
            "meta": meta,
            "arrivals": arrivals,
            "staleness": staleness,
            "quality": quality,
            "per_language": per_language,
            "workers": workers,
            "runtime": runtime,
            "delivery": delivery,
            "transport": transport,
            "flush": flush,
            "drift": list(self.decoder.drift_report()),
        }
