"""Scenario runner of the port: list the registry and hold port runs to the
committed golden traces.

    PYTHONPATH=src python -m repro_torch.scenarios.run list
    PYTHONPATH=src python -m repro_torch.scenarios.run verify dcasgd fedbuff
    PYTHONPATH=src python -m repro_torch.scenarios.run verify drop_stale \\
        --device cpu

``verify`` runs each scenario on the device (the card unless ``--device
cpu``) and compares it with ``results/golden/<name>.json``: the arrival
sequence and ``final_time`` exactly, and ``tokens`` and ``comm_bytes``
exactly when the run has the golden's configuration (its ``scenario``
dict). The goldens' evals and parameter digest are the reference's own
initial draw and are not a target here. It exits non-zero on a mismatch
and records no golden.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.device import resolve_device
from repro_torch.scenarios import registry
from repro_torch.scenarios.spec import Scenario

GOLDEN_DIR = Path(__file__).resolve().parents[3] / "results" / "golden"


def load_golden(name: str) -> Dict:
    return json.loads((GOLDEN_DIR / f"{name}.json").read_text())


def arrival_rows(hist) -> List[list]:
    """The golden's arrival rows: (outer_step, wid, s_i, staleness, lang,
    rho, sim_time, dropped), through JSON as the golden stores them."""
    return json.loads(json.dumps([
        [a["outer_step"], a["worker_id"], a["outer_step"] - 1 - a["staleness"],
         a["staleness"], a["lang"], a["rho"], a["sim_time"],
         bool(a["dropped"])] for a in hist.arrivals]))


def compare(scn: Scenario, hist, golden: Optional[Dict] = None) -> List[str]:
    """Mismatches of a finished run against the scenario's golden."""
    golden = golden or load_golden(scn.name)
    bad = []
    rows = arrival_rows(hist)
    if rows != golden["arrivals"]:
        first = next((i for i, (a, b) in enumerate(zip(rows, golden["arrivals"]))
                      if a != b), min(len(rows), len(golden["arrivals"])))
        bad.append(f"arrivals differ from arrival {first} "
                   f"({len(rows)} vs {len(golden['arrivals'])})")
    checks = [("final_time", hist.final_time)]
    if json.loads(json.dumps(scn.to_dict())) == golden["scenario"]:
        checks += [("tokens", hist.tokens), ("comm_bytes", hist.comm_bytes)]
    for key, got in checks:
        if got != golden[key]:
            bad.append(f"{key} {got} != golden {golden[key]}")
    return bad


def run(scn: Scenario, device="cuda"):
    """Build and run a scenario with its golden's eval cadence; returns
    (engine, history)."""
    from repro_torch.async_engine.engine import make_eval_fn
    eng = scn.build(device=device)
    hist = eng.run(eval_every=scn.eval_cadence,
                   eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    return eng, hist


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.scenarios.run")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="registered scenarios")
    p = sub.add_parser("verify", help="run and compare with the goldens")
    p.add_argument("names", nargs="+", help="scenario names")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.cmd == "list":
        for s in registry.all_scenarios():
            where = "port" if not s.unported_axes() else "not yet"
            print(f"  {s.name:28s} {s.engine:9s} {s.method:16s} [{where}]  "
                  f"{s.description}")
        return 0

    device = resolve_device(args.device)
    failed = 0
    for name in args.names:
        scn = registry.get_scenario(name)
        _eng, hist = run(scn, device)
        bad = compare(scn, hist)
        failed += bool(bad)
        print(f"{'PASS' if not bad else 'FAIL'} {name}: "
              f"{len(hist.arrivals)} arrivals on {device}"
              + "".join(f"\n    {b}" for b in bad))
    print(f"\n{len(args.names) - failed}/{len(args.names)} golden-trace "
          "checks passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
