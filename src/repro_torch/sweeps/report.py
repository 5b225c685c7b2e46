"""Sweep report generator: the paper-style artifacts.

Port of ``repro/sweeps/report.py``, reading the port's own runs. From a
sweep results document (``repro_torch.sweeps.runner``) this renders:

  tables.json / report.md   Table-2-like comparison grids — one table
                            per budget, methods x scenario-cells, final
                            eval loss with the %-delta against the
                            spec's baseline method (negative = better);
  staleness_alignment.json  the Section-5 staleness -> update-quality
                            curves per method, aggregated from the real
                            per-arrival telemetry streams;
  report.md also carries the per-language final-loss breakdown (Fig. 3 /
  Dirichlet non-IID fairness) and the per-method telemetry summaries.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from repro_torch.telemetry import TelemetryRecorder, staleness_alignment


# ---------------------------------------------------------------------------
# Table assembly
# ---------------------------------------------------------------------------

def _col_label(row: Dict) -> str:
    parts = [row["base"]]
    parts += [f"{k}={v}" for k, v in sorted(row.get("overrides",
                                                    {}).items())]
    return " ".join(parts)


def _budget_label(b: Dict) -> str:
    amt = int(b["amount"]) if float(b["amount"]).is_integer() \
        else b["amount"]
    return {"fixed_tokens": f"fixed token budget ({amt} tokens)",
            "fixed_wallclock": f"fixed wall-clock budget ({amt}s)",
            "outer_steps": f"fixed outer steps ({amt})"}[b["kind"]]


def comparison_tables(doc: Dict) -> List[Dict]:
    """One table per budget: {budget, columns, rows: {method: {col:
    {loss, delta_pct}}}} — delta_pct is vs the baseline method."""
    from repro_torch.core import methods as outer_methods
    baseline = doc["baseline"]
    tables = []
    for b in doc["budgets"]:
        cells = [r for r in doc["cells"] if r["budget"] == b]
        if not cells:
            continue
        cols = sorted({_col_label(r) for r in cells})
        by = {(r["method"], _col_label(r)): r for r in cells}
        rows: Dict[str, Dict[str, Dict]] = {}
        for method in doc["methods"]:
            method = outer_methods.canonical(method)
            row = {}
            for col in cols:
                r = by.get((method, col))
                if r is None or r["final_loss"] is None:
                    continue
                base_r = by.get((baseline, col))
                delta = None
                if (method != baseline and base_r is not None
                        and base_r["final_loss"]):
                    delta = 100.0 * (r["final_loss"] - base_r["final_loss"]) \
                        / base_r["final_loss"]
                row[col] = {"loss": r["final_loss"], "delta_pct": delta,
                            "tokens": r["tokens"],
                            "final_time": r["final_time"],
                            "arrivals": r["arrivals"]}
            if row:
                rows[method] = row
        tables.append({"budget": b, "label": _budget_label(b),
                       "baseline": baseline, "columns": cols, "rows": rows})
    return tables


def _fmt_cell(c: Optional[Dict]) -> str:
    if c is None:
        return "—"
    if c["delta_pct"] is None:
        return f"{c['loss']:.4f} (baseline)"
    return f"{c['loss']:.4f} ({c['delta_pct']:+.1f}%)"


def _render_table(t: Dict) -> List[str]:
    lines = [f"## {t['label']}", ""]
    lines.append("| method | " + " | ".join(t["columns"]) + " |")
    lines.append("|---" * (len(t["columns"]) + 1) + "|")
    for method, row in t["rows"].items():
        cells = [_fmt_cell(row.get(col)) for col in t["columns"]]
        lines.append(f"| `{method}` | " + " | ".join(cells) + " |")
    lines.append("")
    lines.append(f"Final mean eval loss; %-delta vs `{t['baseline']}` "
                 "under the same budget (negative = better).")
    lines.append("")
    return lines


# ---------------------------------------------------------------------------
# Section-5 artifacts from the telemetry streams
# ---------------------------------------------------------------------------

def alignment_curves(doc: Dict) -> Dict[str, List[Dict]]:
    """method -> staleness->alignment curve, aggregated over every cell
    of that method that produced a telemetry stream."""
    per_method = defaultdict(list)
    for row in doc["cells"]:
        path = row.get("telemetry")
        if path and os.path.exists(path):
            rec = TelemetryRecorder.read_jsonl(path)
            per_method[row["method"]].extend(rec.arrivals())
    return {m: staleness_alignment(arr) for m, arr in per_method.items()}


def _render_alignment(curves: Dict[str, List[Dict]]) -> List[str]:
    lines = ["## Staleness -> update quality (Section 5)", ""]
    if not any(curves.values()):
        return lines + ["(no telemetry streams recorded)", ""]
    lines.append("| method | staleness | n | mean cos(D, m) | "
                 "mean corrected mass |")
    lines.append("|---|---|---|---|---|")
    for method, curve in sorted(curves.items()):
        for pt in curve:
            lines.append(
                f"| `{method}` | {pt['staleness']} | {pt['n']} | "
                f"{pt['mean_cos_align']:+.4f} | "
                f"{pt['mean_corrected_frac']:.4f} |")
    lines.append("")
    lines.append("cos(D, m): alignment of arriving pseudo-gradients with "
                 "the outer momentum; corrected mass: ||g−D||/||D|| — how "
                 "much the method's correction moved (from the fused-"
                 "kernel telemetry stats, see docs/telemetry.md).")
    lines.append("")
    return lines


def _render_per_language(doc: Dict) -> List[str]:
    lines = ["## Per-language final loss (non-IID fairness)", ""]
    rows = [r for r in doc["cells"] if r.get("per_lang")]
    if not rows:
        return lines + ["(no per-language evals)", ""]
    langs = sorted({lang for r in rows for lang in r["per_lang"]})
    lines.append("| cell | " + " | ".join(langs) + " | spread |")
    lines.append("|---" * (len(langs) + 2) + "|")
    for r in rows:
        per = r["per_lang"]
        vals = [f"{per[lg]:.4f}" if lg in per else "—" for lg in langs]
        spread = max(per.values()) - min(per.values())
        lines.append(f"| `{r['cell_id']}` | " + " | ".join(vals)
                     + f" | {spread:.4f} |")
    lines.append("")
    return lines


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def generate_report(spec, doc: Dict, sweep_dir: str) -> Sequence[str]:
    """Write tables.json + staleness_alignment.json + report.md; returns
    the written paths."""
    tables = comparison_tables(doc)
    curves = alignment_curves(doc)
    paths = []

    p = os.path.join(sweep_dir, "tables.json")
    with open(p, "w") as f:
        json.dump({"sweep": doc["sweep"], "tables": tables}, f, indent=1)
    paths.append(p)

    p = os.path.join(sweep_dir, "staleness_alignment.json")
    with open(p, "w") as f:
        json.dump({"sweep": doc["sweep"], "curves": curves}, f, indent=1)
    paths.append(p)

    lines = [f"# Sweep report: {doc['sweep']}", ""]
    if doc.get("description"):
        lines += [doc["description"], ""]
    lines += [f"{doc['n_cells']} cells = "
              f"{len(doc['methods'])} methods x "
              f"{len(doc['scenarios'])} scenarios x "
              f"{len(doc['budgets'])} budgets"
              f" ({doc['wall_seconds']:.0f}s wall).", ""]
    for t in tables:
        lines += _render_table(t)
    lines += _render_alignment(curves)
    lines += _render_per_language(doc)
    p = os.path.join(sweep_dir, "report.md")
    with open(p, "w") as f:
        f.write("\n".join(lines))
    paths.append(p)
    return paths
