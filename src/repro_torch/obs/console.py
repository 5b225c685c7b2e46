"""Live terminal operator console over a telemetry JSONL stream: the port
of ``repro/obs/console.py``.

``python -m repro_torch.obs console <stream.jsonl>`` tails a stream that a
run is writing now (a ``TelemetryRecorder`` with a live sink,
``--telemetry`` on the launcher), or a recorded one, and renders:

  - arrival rate and totals (commits, drops, tokens, outer step);
  - the staleness histogram;
  - cos(D, m) and corrected-mass sparklines;
  - per-language validation loss;
  - per-worker liveness (arrivals seen, liveness and quarantine states
    from the fault records);
  - runtime health (occupancy, compute parallelism, queue depth: the
    ``runtime`` record kind) and the delivery and chaos counters;
  - per-worker-process transport counters (frames and bytes each way,
    serialize and deserialize time, credit-wait stall, per-round compute:
    the ``transport`` record kind the children ship over the socket
    control channel) and commit-buffer flushes (depth, reason, fused
    against sequential: the ``flush`` record kind).

The numbers come from ``obs.metrics.MetricsAggregator``, which the web
dashboard and the headless snapshot read too; this module only renders
them as ANSI text (unicode sparklines, colour off for non-TTYs).
``--once`` renders one headless snapshot and exits. Follow mode rides
``obs.tail.TailReader`` (partial lines, truncation and rotation) and
decodes through ``StreamDecoder``: a stream of a newer schema keeps
rendering, with what it skipped counted in the footer.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from repro_torch.obs.metrics import MetricsAggregator
from repro_torch.obs.tail import TailReader, read_complete_lines

SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(vals, width: int = 48) -> str:
    vals = [float(v) for v in list(vals)[-width:]]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    top = len(SPARK_BLOCKS) - 1
    return "".join(SPARK_BLOCKS[int(round((v - lo) / span * top))]
                   for v in vals)


def hbar(n: float, n_max: float, width: int = 28) -> str:
    if n_max <= 0:
        return ""
    full = int(round(n / n_max * width))
    return "█" * max(full, 1 if n > 0 else 0)


class ConsoleState(MetricsAggregator):
    """Streaming aggregator: feed lines (or records), read panels.

    All aggregation lives in ``repro_torch.obs.metrics.MetricsAggregator`` —
    the console, the web dashboard, and the headless JSON snapshot all
    read the same numbers; this subclass only keeps the historical
    console-facing name."""


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

class _C:
    """ANSI palette; every accessor collapses to "" when color is off."""
    def __init__(self, on: bool):
        self.on = on

    def _c(self, code: str) -> str:
        return f"\x1b[{code}m" if self.on else ""

    @property
    def dim(self): return self._c("2")
    @property
    def bold(self): return self._c("1")
    @property
    def green(self): return self._c("32")
    @property
    def red(self): return self._c("31")
    @property
    def yellow(self): return self._c("33")
    @property
    def cyan(self): return self._c("36")
    @property
    def off(self): return self._c("0")


def _rule(title: str, width: int, c: _C) -> str:
    pad = max(width - len(title) - 4, 0)
    return f"{c.dim}── {title} {'─' * pad}{c.off}"


def render(state: ConsoleState, width: int = 78, color: bool = False
           ) -> str:
    c = _C(color)
    L: List[str] = []
    m = state.meta
    if m is not None:
        target = f"/{m.outer_steps}" if m.outer_steps else ""
        L.append(f"{c.bold}HeLoCo operator console{c.off} — "
                 f"{m.scenario or 'ad-hoc run'} | method={m.method} "
                 f"engine={m.engine} | {m.n_workers} workers | "
                 f"seed {m.seed} | stream schema v{m.schema_version}")
    else:
        target = ""
        L.append(f"{c.bold}HeLoCo operator console{c.off} — "
                 f"(no meta record yet)")

    # ------------------------------------------------------------- arrivals
    L.append(_rule("arrivals", width, c))
    L.append(f"commits {state.n_arrivals} ({state.n_dropped} dropped) | "
             f"outer step {state.outer_step}{target} | "
             f"tokens {state.tokens_total:,} | "
             f"rate {state.arrival_rate():.2f}/s | "
             f"t={state.last_wall:.1f}s")
    if state.staleness:
        L.append(f"{c.dim}staleness histogram{c.off}")
        n_max = max(state.staleness.values())
        taus = sorted(state.staleness)
        for tau in taus[:8]:
            n = state.staleness[tau]
            L.append(f"  tau={tau:<3d} {hbar(n, n_max):<28} {n}")
        if len(taus) > 8:
            rest = sum(state.staleness[t] for t in taus[8:])
            L.append(f"  tau>{taus[7]:<3d} {hbar(rest, n_max):<28} {rest}")

    # ------------------------------------------------- update quality
    if state.cos:
        L.append(_rule("update quality (recent window)", width, c))
        cw = min(width - 30, 48)
        L.append(f"cos(D,m)   {sparkline(state.cos, cw)}  "
                 f"last={state.cos[-1]:+.3f} "
                 f"mean={sum(state.cos) / len(state.cos):+.3f}")
        L.append(f"corr mass  {sparkline(state.corr, cw)}  "
                 f"last={state.corr[-1]:.3f} "
                 f"mean={sum(state.corr) / len(state.corr):.3f}")

    # ------------------------------------------------------------- eval
    if state.last_eval is not None:
        ev = state.last_eval
        L.append(_rule("per-language loss", width, c))
        L.append(f"eval @step {ev.outer_step}: mean "
                 f"{c.bold}{ev.mean_loss:.4f}{c.off}")
        if ev.per_lang:
            losses = ev.per_lang
            lo, hi = min(losses.values()), max(losses.values())
            for lang in sorted(losses):
                v = losses[lang]
                # bar spans the min..max spread so fairness gaps pop
                frac = (v - lo) / (hi - lo) if hi > lo else 1.0
                L.append(f"  {lang:<10} {v:7.4f} "
                         f"{hbar(0.15 + 0.85 * frac, 1.0, 24)}")
            L.append(f"  {c.dim}spread (max-min): {hi - lo:.4f}{c.off}")

    # ------------------------------------------------------------ workers
    if state.workers:
        L.append(_rule("workers", width, c))
        for wid in sorted(state.workers):
            w = state.workers[wid]
            glyph, col = {"alive": ("●", c.green),
                          "dead": ("✖", c.red),
                          "quarantined": ("⛔", c.yellow)}.get(
                              w["state"], ("?", c.yellow))
            ago = ("" if w["last_wall"] is None else
                   f"  ({max(state.last_wall - w['last_wall'], 0.0):.1f}s "
                   f"since last)")
            last = ("-" if w["last_step"] is None
                    else str(w["last_step"]))
            L.append(f"  w{wid:<3d} {col}{glyph} {w['state']:<12}{c.off} "
                     f"arrivals={w['arrivals']:<5d} last step {last}{ago}")

    # ------------------------------------------------------------ runtime
    rt = state.last_runtime
    if rt is not None:
        L.append(_rule("runtime health", width, c))
        L.append(f"occupancy {rt.server_occupancy:.2f} | "
                 f"parallelism {rt.compute_parallelism:.2f} | "
                 f"queue depth {rt.queue_depth} | "
                 f"in-flight {rt.in_flight} | "
                 f"alive {rt.workers_alive}/{rt.workers_total}")
        if rt.liveness:
            live = " ".join(f"{k}={v}" for k, v
                            in sorted(rt.liveness.items()))
            L.append(f"{c.dim}liveness: {live}{c.off}")

    # --------------------------------------------- cross-process transport
    if state.transport:
        L.append(_rule("transport (per worker process)", width, c))
        for (wid, pid), t in sorted(state.transport.items()):
            mark = "" if t.final else f" {c.yellow}(live){c.off}"
            L.append(f"  w{wid:<3d} pid {pid:<7d} "
                     f"tx {t.frames_sent}f/{t.bytes_sent:,}B "
                     f"rx {t.frames_recv}f/{t.bytes_recv:,}B | "
                     f"ser {t.ser_s * 1e3:.1f}ms "
                     f"deser {t.deser_s * 1e3:.1f}ms | "
                     f"stall {t.credit_wait_s * 1e3:.1f}ms | "
                     f"rounds {t.rounds} "
                     f"compute {t.compute_s:.2f}s{mark}")
            if t.crc_rejects or t.retries:
                L.append(f"       {c.yellow}crc_rejects={t.crc_rejects} "
                         f"retries={t.retries}{c.off}")
        tot = state.transport_totals()
        L.append(f"{c.dim}total: tx {int(tot.get('frames_sent', 0))}f/"
                 f"{int(tot.get('bytes_sent', 0)):,}B "
                 f"rx {int(tot.get('frames_recv', 0))}f/"
                 f"{int(tot.get('bytes_recv', 0)):,}B "
                 f"compute {tot.get('compute_s', 0.0):.2f}s{c.off}")

    # ------------------------------------------------- commit-buffer flush
    if state.n_flushes:
        L.append(_rule("commit-buffer flushes", width, c))
        depths = list(state.flush_depths)
        reasons = " ".join(f"{k}={v}" for k, v
                           in sorted(state.flush_reasons.items()))
        L.append(f"flushes {state.n_flushes} | depth mean "
                 f"{sum(depths) / len(depths):.1f} max "
                 f"{state.flush_depth_max} | fused {state.flush_fused} "
                 f"sequential {state.flush_sequential}")
        L.append(f"{c.dim}reasons: {reasons}{c.off}")
        cw = min(width - 30, 48)
        if len(depths) >= 2:
            L.append(f"depth      {sparkline(depths, cw)}")

    # ---------------------------------------------------- chaos / delivery
    hot = {k: v for k, v in sorted(state.delivery.items()) if v}
    events = {k: v for k, v in sorted(state.fault_counts.items())
              if k != "summary"}
    if hot or events:
        L.append(_rule("delivery / chaos", width, c))
        if hot:
            L.append("counters: " + " ".join(f"{k}={int(v)}"
                                             for k, v in hot.items()))
        if events:
            L.append("events:   " + " ".join(f"{k}={v}"
                                             for k, v in events.items()))

    # ------------------------------------------------------------ drift
    drift = state.decoder.drift_report()
    if drift:
        L.append(_rule("schema drift", width, c))
        for d in drift:
            L.append(f"{c.yellow}! {d}{c.off}")
    return "\n".join(L)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs console",
        description="Terminal operator console over a telemetry JSONL "
                    "stream (live or recorded).")
    ap.add_argument("stream", help="telemetry JSONL path (may not exist "
                                   "yet in follow mode)")
    ap.add_argument("--once", action="store_true",
                    help="render one headless snapshot of the complete "
                         "lines currently in the file, then exit (CI)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="follow-mode refresh seconds (default 1.0)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="follow for N seconds then exit (0 = until ^C)")
    ap.add_argument("--window", type=int, default=256,
                    help="recent-window size for rate/sparklines")
    ap.add_argument("--width", type=int, default=78)
    ap.add_argument("--color", choices=["auto", "always", "never"],
                    default="auto")
    ap.add_argument("--strict", action="store_true",
                    help="fail loudly on schema drift instead of "
                         "counting/reporting it (same-version streams)")
    args = ap.parse_args(argv)
    use_color = (args.color == "always"
                 or (args.color == "auto" and not args.once
                     and sys.stdout.isatty()))
    state = ConsoleState(window=args.window, strict=args.strict)

    if args.once:
        for line in read_complete_lines(args.stream):
            state.add_line(line)
        try:
            print(render(state, width=args.width, color=use_color))
        except BrokenPipeError:                  # e.g. piped into `head`
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0

    reader = TailReader(args.stream, poll=min(args.interval, 0.25))
    t_end = (time.monotonic() + args.duration) if args.duration else None
    try:
        while True:
            for line in reader.read_available():
                state.add_line(line)
            frame = render(state, width=args.width, color=use_color)
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            if t_end is not None and time.monotonic() >= t_end:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    finally:
        reader.close()


if __name__ == "__main__":
    raise SystemExit(main())
