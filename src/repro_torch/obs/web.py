"""Web dashboard over a telemetry JSONL stream, standard library only: the
port of ``repro/obs/web.py``.

``python -m repro_torch.obs web <stream.jsonl>`` serves one self-contained
HTML page (inline CSS and JS, no external request; ``http.server`` and
EventSource) that renders the console's panels: arrival rate and totals,
the staleness histogram, cos(D, m) and corrected-mass sparklines,
per-language validation loss, worker liveness, runtime health, delivery
and chaos counters, the worker processes' transport counters and the
commit-buffer flushes.

Three routes:

  ``/``               the dashboard page;
  ``/events``         Server-Sent Events: one ``panels`` JSON object per
                      refresh interval while the stream grows (follow
                      mode rides ``TailReader``: rotation, truncation and
                      a file that does not exist yet all behave);
  ``/snapshot.json``  the current aggregated panels, once.

The numbers are ``obs.metrics.MetricsAggregator``'s, the console's
rollup; this module only formats them as HTML and JSON. ``--snapshot``
starts no server: it aggregates the complete lines in the file, prints
the panels JSON and exits.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from repro_torch.obs.metrics import MetricsAggregator
from repro_torch.obs.tail import TailReader, read_complete_lines

__all__ = ["main", "snapshot_panels", "PAGE"]


def snapshot_panels(stream: str, window: int = 256,
                    strict: bool = False) -> dict:
    """One-shot aggregation of every complete line in ``stream``."""
    agg = MetricsAggregator(window=window, strict=strict)
    for line in read_complete_lines(stream):
        agg.add_line(line)
    return agg.panels()


# ---------------------------------------------------------------------------
# The page. One self-contained document: inline CSS, inline JS, no
# external requests. The JS opens /events and re-renders every panel
# from the pushed JSON; if SSE drops it falls back to polling
# /snapshot.json.
# ---------------------------------------------------------------------------

PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>HeLoCo dashboard</title>
<style>
  body { background: #101418; color: #d8dee6; margin: 0;
         font: 13px/1.5 ui-monospace, SFMono-Regular, Menlo, monospace; }
  header { padding: 10px 16px; background: #161b22;
           border-bottom: 1px solid #2a3138; }
  header h1 { font-size: 14px; margin: 0; display: inline; }
  #meta { color: #8b949e; margin-left: 12px; }
  #grid { display: grid; gap: 12px; padding: 12px 16px;
          grid-template-columns: repeat(auto-fit, minmax(340px, 1fr)); }
  .panel { background: #161b22; border: 1px solid #2a3138;
           border-radius: 6px; padding: 10px 12px; min-height: 40px; }
  .panel h2 { font-size: 12px; margin: 0 0 6px; color: #79c0ff;
              text-transform: lowercase; letter-spacing: .04em; }
  .kv { color: #d8dee6; } .kv b { color: #f0f6fc; }
  .dim { color: #8b949e; } .warn { color: #e3b341; }
  .bad { color: #f85149; } .ok { color: #56d364; }
  table { border-collapse: collapse; width: 100%; }
  td, th { padding: 1px 8px 1px 0; text-align: left;
           font-weight: normal; white-space: nowrap; }
  th { color: #8b949e; }
  .bar { display: inline-block; background: #2f81f7; height: 9px;
         vertical-align: baseline; }
  .spark { color: #56d364; letter-spacing: -1px; }
  #status { float: right; color: #8b949e; }
  .hidden { display: none; }
</style>
</head>
<body>
<header>
  <h1>HeLoCo dashboard</h1><span id="meta"></span>
  <span id="status">connecting&hellip;</span>
</header>
<div id="grid">
  <div class="panel" id="p-arrivals"><h2>arrivals</h2><div></div></div>
  <div class="panel" id="p-staleness"><h2>staleness</h2><div></div></div>
  <div class="panel" id="p-quality"><h2>update quality</h2><div></div></div>
  <div class="panel" id="p-lang"><h2>per-language loss</h2><div></div></div>
  <div class="panel" id="p-workers"><h2>workers</h2><div></div></div>
  <div class="panel" id="p-runtime"><h2>runtime health</h2><div></div></div>
  <div class="panel" id="p-transport"><h2>transport</h2><div></div></div>
  <div class="panel" id="p-flush"><h2>commit-buffer flushes</h2>
    <div></div></div>
  <div class="panel" id="p-delivery"><h2>delivery / chaos</h2>
    <div></div></div>
  <div class="panel" id="p-drift"><h2>schema drift</h2><div></div></div>
</div>
<script>
"use strict";
const BLOCKS = "\\u2581\\u2582\\u2583\\u2584\\u2585\\u2586\\u2587\\u2588";
function esc(s) {
  return String(s).replace(/[&<>"]/g,
    ch => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[ch]));
}
function spark(vals, width) {
  vals = vals.slice(-(width || 48));
  if (!vals.length) return "";
  const lo = Math.min(...vals), hi = Math.max(...vals);
  const span = (hi - lo) || 1;
  return vals.map(v =>
    BLOCKS[Math.round((v - lo) / span * (BLOCKS.length - 1))]).join("");
}
function bar(n, nMax, w) {
  if (nMax <= 0) return "";
  const px = Math.max(Math.round(n / nMax * (w || 120)), n > 0 ? 2 : 0);
  return '<span class="bar" style="width:' + px + 'px"></span>';
}
function fill(id, html) {
  const p = document.getElementById(id);
  p.classList.toggle("hidden", !html);
  p.querySelector("div").innerHTML = html || "";
}
function fmtBytes(b) {
  if (b > 1048576) return (b / 1048576).toFixed(1) + " MiB";
  if (b > 1024) return (b / 1024).toFixed(1) + " KiB";
  return b + " B";
}
function render(p) {
  const m = p.meta;
  document.getElementById("meta").textContent = m
    ? (m.scenario || "ad-hoc run") + " | method=" + m.method
      + " engine=" + m.engine + " | " + m.n_workers + " workers | seed "
      + m.seed + " | schema v" + m.schema_version
    : "(no meta record yet)";
  const a = p.arrivals;
  const target = m && m.outer_steps ? "/" + m.outer_steps : "";
  fill("p-arrivals",
    '<div class="kv">commits <b>' + a.commits + "</b> (" + a.dropped
    + " dropped) | outer step <b>" + a.outer_step + esc(target)
    + "</b><br>tokens " + a.tokens_total.toLocaleString() + " | rate "
    + a.rate_per_sec.toFixed(2) + "/s | t=" + a.last_wall.toFixed(1)
    + "s</div>");
  const taus = Object.keys(p.staleness);
  if (taus.length) {
    const nMax = Math.max(...Object.values(p.staleness));
    fill("p-staleness", "<table>" + taus.map(t =>
      "<tr><td>tau=" + esc(t) + "</td><td>"
      + bar(p.staleness[t], nMax, 140) + "</td><td>" + p.staleness[t]
      + "</td></tr>").join("") + "</table>");
  } else fill("p-staleness", "");
  const q = p.quality;
  fill("p-quality", q.cos ?
    '<div class="kv">cos(D,m) <span class="spark">' + spark(q.cos)
    + "</span> last=" + q.cos_last.toFixed(3) + " mean="
    + q.cos_mean.toFixed(3) + '<br>corr mass <span class="spark">'
    + spark(q.corr) + "</span> last=" + q.corr_last.toFixed(3)
    + " mean=" + q.corr_mean.toFixed(3) + "</div>" : "");
  const lg = p.per_language;
  if (lg.per_lang && Object.keys(lg.per_lang).length) {
    const vals = Object.values(lg.per_lang);
    const lo = Math.min(...vals), hi = Math.max(...vals);
    fill("p-lang",
      '<div class="kv">eval @step ' + lg.outer_step + ": mean <b>"
      + lg.mean_loss.toFixed(4) + "</b></div><table>"
      + Object.keys(lg.per_lang).sort().map(l => {
          const v = lg.per_lang[l];
          const frac = hi > lo ? (v - lo) / (hi - lo) : 1;
          return "<tr><td>" + esc(l) + "</td><td>" + v.toFixed(4)
            + "</td><td>" + bar(0.15 + 0.85 * frac, 1, 110)
            + "</td></tr>";
        }).join("") + "</table>"
      + '<div class="dim">spread (max-min): '
      + (lg.spread || 0).toFixed(4) + "</div>");
  } else fill("p-lang", "");
  const wids = Object.keys(p.workers);
  fill("p-workers", wids.length ? "<table>" + wids.map(w => {
      const d = p.workers[w];
      const cls = {alive: "ok", dead: "bad",
                   quarantined: "warn"}[d.state] || "warn";
      return "<tr><td>w" + esc(w) + '</td><td class="' + cls + '">'
        + esc(d.state) + "</td><td>arrivals=" + d.arrivals
        + "</td><td>last step " + (d.last_step == null ? "-"
        : d.last_step) + "</td></tr>";
    }).join("") + "</table>" : "");
  const rt = p.runtime;
  fill("p-runtime", rt.workers_total !== undefined ?
    '<div class="kv">occupancy ' + rt.server_occupancy.toFixed(2)
    + " | parallelism " + rt.compute_parallelism.toFixed(2)
    + " | queue depth " + rt.queue_depth + "<br>in-flight "
    + rt.in_flight + " | alive " + rt.workers_alive + "/"
    + rt.workers_total + "</div>" : "");
  const tp = p.transport;
  if (tp.workers && Object.keys(tp.workers).length) {
    const tot = tp.totals;
    fill("p-transport", "<table><tr><th>w/pid</th><th>tx</th><th>rx</th>"
      + "<th>ser</th><th>stall</th><th>rounds</th><th>compute</th></tr>"
      + Object.keys(tp.workers).map(k => {
          const t = tp.workers[k];
          const warn = (t.crc_rejects || t.retries)
            ? ' <span class="warn">crc=' + t.crc_rejects + " retry="
              + t.retries + "</span>" : "";
          return "<tr><td>" + esc(k) + (t.final ? "" :
              ' <span class="warn">live</span>')
            + "</td><td>" + t.frames_sent + "f/" + fmtBytes(t.bytes_sent)
            + "</td><td>" + t.frames_recv + "f/" + fmtBytes(t.bytes_recv)
            + "</td><td>" + (t.ser_s * 1e3).toFixed(1) + "ms</td><td>"
            + (t.credit_wait_s * 1e3).toFixed(1) + "ms</td><td>"
            + t.rounds + "</td><td>" + t.compute_s.toFixed(2) + "s"
            + warn + "</td></tr>";
        }).join("") + "</table>"
      + '<div class="dim">total: tx ' + (tot.frames_sent || 0) + "f/"
      + fmtBytes(tot.bytes_sent || 0) + " rx " + (tot.frames_recv || 0)
      + "f/" + fmtBytes(tot.bytes_recv || 0) + " compute "
      + (tot.compute_s || 0).toFixed(2) + "s</div>");
  } else fill("p-transport", "");
  const fl = p.flush;
  fill("p-flush", fl.flushes ?
    '<div class="kv">flushes <b>' + fl.flushes + "</b> | depth mean "
    + fl.depth_mean.toFixed(1) + " max " + fl.depth_max + " | fused "
    + fl.fused + " sequential " + fl.sequential
    + '</div><div class="dim">reasons: '
    + Object.keys(fl.reasons).sort().map(r => esc(r) + "="
      + fl.reasons[r]).join(" ") + "</div>" : "");
  const dc = p.delivery.counters, de = p.delivery.events;
  const hasD = Object.keys(dc).length || Object.keys(de).length;
  fill("p-delivery", hasD ?
    '<div class="kv">' + (Object.keys(dc).length ? "counters: "
      + Object.keys(dc).map(k => esc(k) + "=" + Math.round(dc[k]))
        .join(" ") + "<br>" : "")
    + (Object.keys(de).length ? "events: "
      + Object.keys(de).map(k => esc(k) + "=" + de[k]).join(" ") : "")
    + "</div>" : "");
  fill("p-drift", p.drift.length ? p.drift.map(d =>
    '<div class="warn">! ' + esc(d) + "</div>").join("") : "");
}
function setStatus(s, cls) {
  const el = document.getElementById("status");
  el.textContent = s;
  el.className = cls || "";
}
let es = null, pollTimer = null;
function poll() {
  fetch("/snapshot.json").then(r => r.json()).then(p => {
    render(p); setStatus("polling", "warn");
  }).catch(() => setStatus("disconnected", "bad"));
}
function connect() {
  es = new EventSource("/events");
  es.onmessage = ev => {
    if (pollTimer) { clearInterval(pollTimer); pollTimer = null; }
    setStatus("live", "ok");
    render(JSON.parse(ev.data));
  };
  es.onerror = () => {
    setStatus("sse lost; polling", "warn");
    if (!pollTimer) pollTimer = setInterval(poll, 2000);
  };
}
poll();
connect();
</script>
</body>
</html>
"""


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class _Hub:
    """One tail-following aggregation shared by every request: a
    background thread drains the TailReader into the MetricsAggregator;
    handlers snapshot ``panels()`` under the lock. The aggregate is
    monotone (counters and latest-wins records), so concurrent SSE
    clients all see the same stream state."""

    def __init__(self, stream: str, window: int = 256,
                 strict: bool = False, poll: float = 0.25):
        self.agg = MetricsAggregator(window=window, strict=strict)
        self.reader = TailReader(stream, poll=poll)
        self.poll = poll
        self.version = 0                 # bumped per batch of new lines
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump,
                                        name="obs-web-tail", daemon=True)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.reader.close()

    def _pump(self):
        while not self._stop.wait(self.poll):
            lines = self.reader.read_available()
            if not lines:
                continue
            with self._lock:
                for ln in lines:
                    self.agg.add_line(ln)
                self.version += 1

    def panels(self) -> dict:
        with self._lock:
            return self.agg.panels()


class _Handler(BaseHTTPRequestHandler):
    hub: _Hub                            # injected by serve()
    sse_interval = 1.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # quiet by default
        pass

    def _send(self, code: int, ctype: str, body: bytes,
              extra: Optional[dict] = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):                    # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/":
            self._send(200, "text/html; charset=utf-8",
                       PAGE.encode("utf-8"))
        elif path == "/snapshot.json":
            body = json.dumps(self.hub.panels()).encode("utf-8")
            self._send(200, "application/json", body)
        elif path == "/events":
            self._sse()
        else:
            self._send(404, "text/plain; charset=utf-8", b"not found\n")

    def _sse(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        last_version = -1
        try:
            while True:
                version = self.hub.version
                if version != last_version:
                    last_version = version
                    data = json.dumps(self.hub.panels())
                    self.wfile.write(b"data: " + data.encode("utf-8")
                                     + b"\n\n")
                    self.wfile.flush()
                else:
                    # comment frame keeps the connection alive through
                    # quiet stretches (and surfaces a dead client)
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
                time.sleep(self.sse_interval)
        except (BrokenPipeError, ConnectionResetError, OSError):
            return                       # client went away


def serve(stream: str, host: str, port: int, *, window: int = 256,
          strict: bool = False, interval: float = 1.0,
          duration: float = 0.0, quiet: bool = False) -> int:
    hub = _Hub(stream, window=window, strict=strict)
    hub.start()
    handler = type("Handler", (_Handler,),
                   {"hub": hub, "sse_interval": interval})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    if not quiet:
        print(f"dashboard: http://{host}:{httpd.server_address[1]}/ "
              f"(stream: {stream})", file=sys.stderr)
    try:
        if duration > 0:
            t = threading.Timer(duration, httpd.shutdown)
            t.daemon = True
            t.start()
        httpd.serve_forever(poll_interval=0.25)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        hub.stop()
    return 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs web",
        description="Web dashboard over a telemetry JSONL stream "
                    "(live or recorded); stdlib only.")
    ap.add_argument("stream", help="telemetry JSONL path (may not exist "
                                   "yet; the tail reader waits)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8377,
                    help="0 picks a free port (printed on stderr)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="SSE push interval seconds (default 1.0)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="serve for N seconds then exit (0 = until ^C)")
    ap.add_argument("--window", type=int, default=256,
                    help="recent-window size for rate/sparklines")
    ap.add_argument("--strict", action="store_true",
                    help="fail loudly on same-version schema drift")
    ap.add_argument("--snapshot", action="store_true",
                    help="no server: aggregate the complete lines now "
                         "in the file, print panels JSON, exit (CI)")
    args = ap.parse_args(argv)
    if args.snapshot:
        panels = snapshot_panels(args.stream, window=args.window,
                                 strict=args.strict)
        json.dump(panels, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    return serve(args.stream, args.host, args.port, window=args.window,
                 strict=args.strict, interval=args.interval,
                 duration=args.duration)


if __name__ == "__main__":
    raise SystemExit(main())
