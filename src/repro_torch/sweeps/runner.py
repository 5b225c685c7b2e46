"""Sweep executor: every grid cell through the port's cached runs.

Port of ``repro/sweeps/runner.py``, built on
``repro_torch.sweeps.cache.run_cached_scenario`` (so a sweep rerun after an
interrupted grid only recomputes the missing cells), with the cell's
``Budget`` as the stopping rule and a per-cell telemetry JSONL stream. The
cells run on the card unless ``device="cpu"`` is given.

Layout under ``<out_dir>/<spec.name>/``:

  results.json                     cell descriptors + per-cell summaries
  telemetry/<cell_id>.jsonl        per-arrival update-quality streams
  report.md, tables.json,
  staleness_alignment.json         see ``repro_torch.sweeps.report``
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from repro_torch.device import resolve_device
from repro_torch.sweeps.cache import run_cached_scenario
from repro_torch.sweeps.spec import SweepCell, SweepSpec, get_sweep

SWEEP_DIR = os.environ.get("REPRO_TORCH_SWEEPS", "results/torch_sweeps")


def _run_cell(cell: SweepCell, spec: SweepSpec, sweep_dir: str,
              force: bool, device) -> Dict:
    telemetry_path = (os.path.join(sweep_dir, "telemetry",
                                   cell.cell_id + ".jsonl")
                      if spec.telemetry else None)
    res = run_cached_scenario(cell.cell_id, cell.scenario,
                              eval_every=spec.eval_every, force=force,
                              budget=cell.budget.to_budget(),
                              telemetry_path=telemetry_path,
                              device=device)
    return {
        **cell.to_dict(),
        "final_loss": res.get("final_loss"),
        "per_lang": res.get("per_lang"),
        "tokens": res.get("tokens"),
        "final_time": res.get("final_time"),
        "arrivals": len(res.get("staleness", [])),
        "n_dropped": res.get("n_dropped", 0),
        "telemetry": res.get("telemetry"),
        "telemetry_summary": res.get("telemetry_summary"),
        "wall_seconds": res.get("wall_seconds"),
    }


def run_sweep(spec, out_dir: Optional[str] = None, force: bool = False,
              report: bool = True, verbose: bool = True,
              device="cuda") -> Dict:
    """Execute a sweep (by ``SweepSpec`` or registered name) on ``device``;
    returns the results document and writes the report artifacts."""
    if isinstance(spec, str):
        spec = get_sweep(spec)
    device = resolve_device(device)
    sweep_dir = os.path.join(out_dir or SWEEP_DIR, spec.name)
    os.makedirs(sweep_dir, exist_ok=True)
    cells = spec.cells()
    rows: List[Dict] = []
    t0 = time.time()
    for i, cell in enumerate(cells):
        if verbose:
            print(f"[{i + 1}/{len(cells)}] {cell.cell_id}", flush=True)
        rows.append(_run_cell(cell, spec, sweep_dir, force, device))
    doc = {
        "sweep": spec.name,
        "description": spec.description,
        "device": device.type,
        "baseline": spec.baseline_method,
        "methods": list(spec.methods),
        "scenarios": list(spec.scenarios),
        "budgets": [{"kind": b.kind, "amount": b.amount}
                    for b in spec.budgets],
        "n_cells": len(cells),
        "cells": rows,
        "wall_seconds": time.time() - t0,
    }
    path = os.path.join(sweep_dir, "results.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    if verbose:
        print(f"# results -> {path}")
    if report:
        from repro_torch.sweeps.report import generate_report
        for p in generate_report(spec, doc, sweep_dir):
            if verbose:
                print(f"# report  -> {p}")
    return doc
