"""Scenario runner of the port: list the registry, record golden traces
from port runs, and hold port runs to the committed ones.

    PYTHONPATH=src python -m repro_torch.scenarios list
    PYTHONPATH=src python -m repro_torch.scenarios.run list \\
        --engine-filter sim
    PYTHONPATH=src python -m repro_torch.scenarios.run record --all \\
        --engine-filter sim --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios.run verify --all \\
        --engine-filter sim --device cpu
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

The selection is the reference's: the names given, or every registered
scenario with ``--all`` or with no name, narrowed by ``--engine-filter``
and ``--transport-filter``; ``list`` groups by engine and transport.
``record`` runs each selected scenario on the device and writes its trace
in the reference's golden format to ``--dir``, ``results/torch_golden`` by
default; a directory under ``results/golden``, which holds the
reference's committed goldens, is refused before anything runs.
``verify`` runs each scenario on the device (the card unless ``--device
cpu``) and holds it to ``results/golden/<name>.json`` through
``trace.verify``: exactly (arrivals, ``tokens``, ``comm_bytes`` and
``final_time``) for the simulator and the deterministic wall-clock runtime,
inside ``trace.FREE_BANDS`` for the free-running runtime. ``--cross``
also replays sim scenarios on the deterministic runtime and holds the
replay's parameter fingerprint to the simulator's run. ``--transport
socket`` reruns the wall-clock scenarios (and, with ``--cross``, the sim
scenarios' replays) over worker processes against the same goldens: the
backend must not change the trace; ``--cross-only`` runs only the
replays. ``--obs`` reruns each check with
the whole observability stack on (a live telemetry sink, runtime records,
a span tracer and, over processes, the children's obs frames): the run
must still verify and its Chrome trace validate. The goldens' evals
and parameter digest are the reference's own initial draw and are not a
target here. It exits non-zero on a mismatch.
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
RECORD_DIR: Path = trace.RECORD_DIR
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


def select(names=(), all_: bool = False, engine_filter=None,
           transport_filter=None) -> List[Scenario]:
    """The reference's selection, grouped as it runs them: the named
    scenarios, or all of them with ``all_`` or no name, kept where their
    engine and transport match the filters; sorted by engine, transport,
    mode and name."""
    scns = (registry.all_scenarios() if all_ or not names
            else [registry.get_scenario(n) for n in names])
    if engine_filter:
        scns = [s for s in scns if s.engine == engine_filter]
    if transport_filter:
        scns = [s for s in scns if s.transport == transport_filter]
    return sorted(scns, key=lambda s: (s.engine, s.transport, s.mode,
                                       s.name))


def print_list(scns: List[Scenario]):
    """The reference's listing: a header per (engine, transport) group,
    then each scenario's name, mode, exactness, topology and description."""
    group = None
    for s in scns:
        if (s.engine, s.transport) != group:
            group = (s.engine, s.transport)
            print(f"-- engine={s.engine} transport={s.transport} --")
        exact = "exact" if s.exact else "banded"
        topo = "" if s.topology == "hub" else f" topo={s.topology}"
        print(f"  {s.name:24s} {s.mode:13s} [{exact}]{topo}  "
              f"{s.description}")
    print(f"\n{len(scns)} scenarios")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.scenarios.run")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list", help="registered scenarios")
    p_list.add_argument("--engine-filter", choices=["sim", "wallclock"])
    p_list.add_argument("--transport-filter", choices=["inproc", "socket"])
    for name, hlp, where in (
            ("record", "run and write golden traces", RECORD_DIR),
            ("verify", "run and compare with the goldens", GOLDEN_DIR)):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("names", nargs="*", help="scenario names "
                       "(default: all)")
        p.add_argument("--all", action="store_true")
        p.add_argument("--dir", default=str(where),
                       help="golden trace directory")
        p.add_argument("--engine-filter", choices=["sim", "wallclock"])
        p.add_argument("--transport-filter", choices=["inproc", "socket"],
                       help="select only scenarios registered on this "
                            "transport")
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
        if name == "verify":
            p.add_argument("--cross", action="store_true",
                           help="also replay sim scenarios on the "
                                "deterministic wall-clock runtime")
            p.add_argument("--cross-only", action="store_true",
                           help="run only the cross-engine replays")
            p.add_argument("--transport", choices=["socket"],
                           help="rerun over this wall-clock backend against "
                                "the committed goldens")
            p.add_argument("--obs", action="store_true",
                           help="rerun with the whole observability stack "
                                "on (live telemetry, span tracing; the "
                                "children's obs frames over processes): "
                                "observation must not change the golden "
                                "trace")
            p.add_argument("--diff-dir", default="",
                           help="write a JSON report of each failure here")
    args = ap.parse_args(argv)

    if args.cmd == "list":
        print_list(select(engine_filter=args.engine_filter,
                          transport_filter=args.transport_filter))
        return 0

    if args.cmd == "record" and trace.refused_dir(args.dir):
        print(f"refusing --dir {args.dir}: {GOLDEN_DIR} holds the "
              f"reference's goldens; the port records to {RECORD_DIR}",
              file=sys.stderr)
        return 2
    scns = select(args.names, args.all, args.engine_filter,
                  args.transport_filter)
    if not scns:
        print("no scenarios selected", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    if args.cmd == "record":
        for s in scns:
            print(f"recorded {s.name} -> "
                  f"{trace.record(s, args.dir, device=device)}")
        return 0

    failed = total = skipped = 0
    for scn in scns:
        cross = [True] if ((args.cross or args.cross_only)
                           and scn.engine == "sim") else []
        for replay in ([] if args.cross_only else [False]) + cross:
            # a transport override reruns wall-clock scenarios on the other
            # backend; a sim scenario only through its cross replay
            if args.transport and not replay and scn.engine != "wallclock":
                skipped += 1
                continue
            res = trace.verify(scn, args.dir, cross_engine=replay,
                               device=device, transport=args.transport,
                               obs=args.obs)
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
        print("no golden-trace check applies to this selection "
              "(--cross-only applies to sim scenarios)", file=sys.stderr)
        return 2
    print(f"\n{total - failed}/{total} golden-trace checks passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
