"""Scenario runner of the port: list the registry and hold port runs to the
committed golden traces.

    PYTHONPATH=src python -m repro_torch.scenarios.run list
    PYTHONPATH=src python -m repro_torch.scenarios.run verify dcasgd fedbuff
    PYTHONPATH=src python -m repro_torch.scenarios.run verify drop_stale \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios.run verify \\
        wallclock_hetero chaos_lossy wallclock_free --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios.run verify --cross \\
        paper_hetero_severe --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios.run verify socket_hetero \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios.run verify chaos_lossy \\
        --transport socket --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios.run list \\
        --transport-filter socket
    PYTHONPATH=src python -m repro_torch.scenarios.run verify \\
        paper_hetero_severe socket_hetero --obs --device cpu

``verify`` runs each scenario on the device (the card unless ``--device
cpu``) and holds it to ``results/golden/<name>.json`` through
``trace.verify``: exactly (arrivals, ``tokens``, ``comm_bytes`` and
``final_time``) for the simulator and the deterministic wall-clock runtime,
inside ``trace.FREE_BANDS`` for the free-running runtime. ``--cross``
also replays sim scenarios on the deterministic runtime and holds the
replay's parameter fingerprint to the simulator's run. ``--transport
socket`` reruns the wall-clock scenarios (and, with ``--cross``, the sim
scenarios' replays) over worker processes against the same goldens: the
backend must not change the trace. ``--transport-filter`` keeps only the
scenarios registered on one transport. ``--obs`` reruns each check with
the whole observability stack on (a live telemetry sink, runtime records,
a span tracer and, over processes, the children's obs frames): the run
must still verify and its Chrome trace validate. The goldens' evals
and parameter digest are the reference's own initial draw and are not a
target here. It exits non-zero on a mismatch and records no golden.
``compare`` holds a finished run to a golden's arrivals the same way, and
its tokens and communication too when the run has the golden's
configuration.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.device import resolve_device
from repro_torch.scenarios import registry, trace
from repro_torch.scenarios.spec import Scenario

GOLDEN_DIR: Path = trace.GOLDEN_DIR
arrival_rows = trace.arrival_rows
load_golden = trace.load_golden
run = trace.run_scenario


def compare(scn: Scenario, hist, golden: Optional[Dict] = None) -> List[str]:
    """Mismatches of a finished run against the scenario's golden, through
    ``trace``'s comparator: the arrivals, ``final_time`` and the eval count,
    and ``tokens`` and ``comm_bytes`` too when the run has the golden's
    configuration."""
    golden = golden or load_golden(scn.name)
    got = {"arrivals": arrival_rows(hist), "evals": hist.evals,
           "tokens": hist.tokens, "comm_bytes": hist.comm_bytes,
           "final_time": hist.final_time}
    keys = ("final_time",)
    if json.loads(json.dumps(scn.to_dict())) == golden["scenario"]:
        keys = ("tokens", "comm_bytes", "final_time")
    bad: List[str] = []
    trace._cmp_counts(bad, got, golden, keys)
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.scenarios.run")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list", help="registered scenarios")
    p_list.add_argument("--transport-filter", choices=["inproc", "socket"])
    p = sub.add_parser("verify", help="run and compare with the goldens")
    p.add_argument("names", nargs="+", help="scenario names")
    p.add_argument("--transport-filter", choices=["inproc", "socket"],
                   help="keep only the named scenarios registered on this "
                        "transport")
    p.add_argument("--transport", choices=["socket"],
                   help="rerun over this wall-clock backend against the "
                        "committed goldens")
    p.add_argument("--cross", action="store_true",
                   help="also replay sim scenarios on the deterministic "
                        "wall-clock runtime")
    p.add_argument("--obs", action="store_true",
                   help="rerun with the whole observability stack on "
                        "(live telemetry, span tracing; the children's obs "
                        "frames over processes): observation must not "
                        "change the golden trace")
    p.add_argument("--diff-dir", default="",
                   help="write a JSON report of each failure here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.cmd == "list":
        for s in registry.all_scenarios():
            if args.transport_filter and s.transport != args.transport_filter:
                continue
            missing = s.unported_axes()
            where = "port" if not missing else f"not yet: {'; '.join(missing)}"
            print(f"  {s.name:28s} {s.engine:9s} {s.method:16s} [{where}]  "
                  f"{s.description}")
        return 0

    device = resolve_device(args.device)
    failed = total = skipped = 0
    for name in args.names:
        scn = registry.get_scenario(name)
        if args.transport_filter and scn.transport != args.transport_filter:
            continue
        for cross in [False] + [True] * (args.cross and scn.engine == "sim"):
            # a transport override reruns wall-clock scenarios on the other
            # backend; a sim scenario only through its cross replay
            if args.transport and not cross and scn.engine != "wallclock":
                skipped += 1
                continue
            res = trace.verify(scn, cross_engine=cross, device=device,
                               transport=args.transport, obs=args.obs)
            total += 1
            failed += not res.ok
            print(f"{'PASS' if res.ok else 'FAIL'} {res.name} on {device}"
                  + "".join(f"\n    {b}" for b in res.failures))
            if not res.ok and args.diff_dir:
                print(f"    diff -> {trace.write_diff(res, args.diff_dir)}")
    if skipped:
        print(f"({skipped} sim checks skipped under --transport "
              f"{args.transport}; --cross replays them)")
    if not total:
        print("no golden-trace check applies to this selection",
              file=sys.stderr)
        return 2
    print(f"\n{total - failed}/{total} golden-trace checks passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
