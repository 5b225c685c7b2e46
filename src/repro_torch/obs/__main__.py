"""``python -m repro_torch.obs``: the observability command line, the port
of ``repro/obs/__main__.py``.

Subcommands:

  console <stream.jsonl> [--once|--interval S]   live operator console
  web <stream.jsonl> [--port N|--snapshot]       web dashboard (stdlib
                                                 http.server + SSE) or
                                                 headless panels JSON
  trace --validate <trace.json>                  trace-event JSON check
  record <scenario> --out <stream.jsonl>         run a scenario with a
                                                 live telemetry sink
                                                 [--trace t.json]
                                                 [--device cpu]

Exit codes: 0, 1 for an invalid trace, 2 for an unknown subcommand.
``console``, ``web`` and ``trace`` import no torch; ``record`` imports the
engine stack and runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import List, Optional

USAGE = __doc__


def _trace_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs trace",
        description="Validate/summarize a Chrome trace-event JSON file.")
    ap.add_argument("path", help="trace JSON (from --trace / SpanTracer)")
    ap.add_argument("--validate", action="store_true",
                    help="exit non-zero if the file is not a well-formed "
                         "trace-event document")
    args = ap.parse_args(argv)
    from repro_torch.obs.spans import validate_chrome_trace
    with open(args.path) as f:
        doc = json.load(f)
    problems = validate_chrome_trace(doc)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    spans = [e for e in events
             if isinstance(e, dict) and e.get("ph") == "X"]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in spans:
        agg = by_name[e.get("name", "?")]
        agg[0] += 1
        agg[1] += float(e.get("dur", 0.0))
    threads = {e.get("tid") for e in events
               if isinstance(e, dict) and e.get("ph") != "M"}
    print(f"{args.path}: {len(events)} events, {len(spans)} spans, "
          f"{len(threads)} threads")
    for name, (n, total_us) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1]):
        print(f"  {name:<24} x{n:<6d} total {total_us / 1e3:9.2f} ms")
    if problems:
        print(f"INVALID: {len(problems)} problem(s)", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    print("trace OK (loadable in Perfetto / chrome://tracing)")
    return 0


def _record_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs record",
        description="Run a registered scenario with a live telemetry "
                    "sink (and optionally a span trace).")
    ap.add_argument("scenario", help="registry name, e.g. chaos_partition")
    ap.add_argument("--out", required=True, help="telemetry JSONL sink")
    ap.add_argument("--runtime-every", type=int, default=1,
                    help="runtime-health record cadence in commits "
                         "(default 1; 0 = off)")
    ap.add_argument("--trace", default=None,
                    help="also export a Chrome trace to this path")
    ap.add_argument("--transport", default=None,
                    help="override the scenario's wallclock backend "
                         "(socket: the worker processes ship their spans "
                         "and wire counters, so the stream gains "
                         "'transport' records)")
    ap.add_argument("--commit-batch", type=int, default=None,
                    help="override the scenario's commit-buffer size "
                         "(>1 makes the stream carry 'flush' records)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # the engine stack only on this path
    import os
    from repro_torch.async_engine.engine import make_eval_fn
    from repro_torch.obs.spans import SpanTracer
    from repro_torch.scenarios import registry
    from repro_torch.telemetry import TelemetryRecorder

    scn = registry.get_scenario(args.scenario)
    over = {}
    if args.transport is not None:
        over["transport"] = args.transport
    if args.commit_batch is not None:
        over["commit_batch"] = args.commit_batch
    if over:
        scn = scn.overridden(**over)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    rec = TelemetryRecorder(sink=args.out)
    tracer = SpanTracer() if args.trace else None
    eng = scn.build(device=args.device, telemetry=rec, tracer=tracer,
                    runtime_record_every=args.runtime_every)
    eng.run(eval_every=scn.eval_cadence,
            eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    # over worker processes, a child that never reported in fails the run
    if hasattr(eng, "assert_child_reports"):
        eng.assert_child_reports()
    rec.close()
    print(f"wrote {args.out} ({len(rec)} records in final window)")
    if tracer is not None:
        tracer.write(args.trace)
        print(f"wrote {args.trace} ({len(tracer)} events)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "console":
        from repro_torch.obs.console import main as console_main
        return console_main(rest)
    if cmd == "web":
        from repro_torch.obs.web import main as web_main
        return web_main(rest)
    if cmd == "trace":
        return _trace_main(rest)
    if cmd == "record":
        return _record_main(rest)
    print(f"unknown subcommand {cmd!r}\n{USAGE}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
