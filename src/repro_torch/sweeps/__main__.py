"""Sweep CLI of the port; ``run`` runs on the card unless ``--device cpu``
is given, and raises without a GPU otherwise.

    PYTHONPATH=src python -m repro_torch.sweeps list
    PYTHONPATH=src python -m repro_torch.sweeps run smoke
    PYTHONPATH=src python -m repro_torch.sweeps run smoke --device cpu
    PYTHONPATH=src python -m repro_torch.sweeps run paper_table2 --force
    PYTHONPATH=src python -m repro_torch.sweeps report smoke  # re-render only
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.sweeps import (
    SWEEP_DIR, all_sweeps, generate_report, get_sweep, run_sweep,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.sweeps")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="registered sweep specs")

    p_run = sub.add_parser("run", help="execute a sweep + write its report")
    p_run.add_argument("name")
    p_run.add_argument("--out", default=SWEEP_DIR)
    p_run.add_argument("--force", action="store_true",
                       help="ignore cached cell results")
    p_run.add_argument("--no-report", action="store_true")
    p_run.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    p_rep = sub.add_parser("report", help="re-render the report from an "
                                          "existing results.json")
    p_rep.add_argument("name")
    p_rep.add_argument("--out", default=SWEEP_DIR)

    args = ap.parse_args(argv)

    if args.cmd == "list":
        for s in all_sweeps():
            grid = (f"{len(s.methods)}m x {len(s.scenarios)}s x "
                    f"{len(s.budgets)}b")
            print(f"{s.name:20s} [{grid:14s}] {s.description}")
        return 0

    if args.cmd == "run":
        run_sweep(args.name, out_dir=args.out, force=args.force,
                  report=not args.no_report, device=args.device)
        return 0

    # report
    spec = get_sweep(args.name)
    path = os.path.join(args.out, spec.name, "results.json")
    if not os.path.exists(path):
        print(f"no results at {path}; run the sweep first",
              file=sys.stderr)
        return 2
    with open(path) as f:
        doc = json.load(f)
    for p in generate_report(spec, doc, os.path.join(args.out, spec.name)):
        print(f"# report -> {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
