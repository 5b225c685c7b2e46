"""Cached budgeted runs: the port's counterpart of the reference's
benchmark harness (``benchmarks/common.py``: ``_key``, ``run_cached``,
``run_cached_scenario``), which its sweep runner is built on.

Each run of a ``Scenario`` is stored as JSON under ``RESULTS_DIR``
(``results/torch_experiments``, or ``$REPRO_TORCH_RESULTS``), keyed by the
run configuration, the eval cadence and batch, the budget, whether a
telemetry stream is written and the device, so a CPU run is never served
as a card run; a sweep run again after an interrupted grid recomputes only
the missing cells.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, Optional

from repro_torch.async_engine.engine import Budget, make_eval_fn
from repro_torch.device import resolve_device
from repro_torch.scenarios.spec import Scenario, load_pace_trace
from repro_torch.telemetry import TelemetryRecorder

RESULTS_DIR = os.environ.get("REPRO_TORCH_RESULTS",
                             "results/torch_experiments")


def _key(scn: Scenario, eval_every: int, eval_batch: int = 8,
         budget: Optional[Budget] = None, telemetry: bool = False,
         device: str = "cuda") -> str:
    blob = json.dumps(dataclasses.asdict(scn.run_config()), sort_keys=True,
                      default=str)
    tag = f"|device:{device}"
    if eval_batch != 8:
        tag += f"eb{eval_batch}"
    if budget is not None:
        tag += f"|budget:{budget.kind}:{budget.amount}"
    if telemetry:
        tag += "|telem"
    return hashlib.sha1((blob + str(eval_every) + tag).encode()
                        ).hexdigest()[:16]


def _has_schedule(scn: Scenario) -> bool:
    """Whether the run has crashes or membership changes, its own or its
    pace trace's."""
    if scn.failures or scn.elastic:
        return True
    if scn.pace_trace:
        trace = load_pace_trace(scn.pace_trace)
        return bool(trace.get("failures") or trace.get("elastic"))
    return False


def run_cached_scenario(name: str, scn: Scenario, eval_every: int = 0,
                        force: bool = False, budget: Optional[Budget] = None,
                        telemetry_path: Optional[str] = None,
                        device="cuda") -> Dict:
    """Run (or reload) one cached run of ``scn`` on ``device``, every
    ``eval_every`` commits (0: the scenario's cadence), with the eval batch
    of the scenario.

    budget: an optional ``Budget`` stopping rule, part of the key.
    telemetry_path: when set, stream per-arrival update-quality telemetry
    to this JSONL path; the cache is reused only if the stream file still
    exists beside the result JSON."""
    device = resolve_device(device)
    if _has_schedule(scn):
        raise ValueError("run_cached_scenario does not cache runs with "
                         "failure/elastic schedules; use scn.build()")
    eval_every = eval_every or scn.eval_cadence
    os.makedirs(RESULTS_DIR, exist_ok=True)
    key = _key(scn, eval_every, scn.eval_batch, budget,
               telemetry_path is not None, device.type)
    path = os.path.join(RESULTS_DIR, f"{name}__{key}.json")
    if os.path.exists(path) and not force and (
            telemetry_path is None or os.path.exists(telemetry_path)):
        with open(path) as f:
            return json.load(f)
    rec = TelemetryRecorder() if telemetry_path is not None else None
    eng = scn.overridden(name=name).build(device=device, telemetry=rec)
    eval_fn = make_eval_fn(eng, batch=scn.eval_batch)
    t0 = time.time()
    hist = eng.run(eval_every=eval_every, eval_fn=eval_fn, budget=budget)
    rc = eng.cfg
    out = {
        "name": name,
        "engine": scn.engine,
        "device": device.type,
        "config": {"paces": rc.worker_paces, "method": rc.outer.method,
                   "non_iid": rc.non_iid, "dylu": rc.dylu,
                   "outer_steps": rc.outer_steps,
                   "inner_steps": rc.inner_steps,
                   "compression": rc.outer.compression,
                   "drop_stale_after": rc.outer.drop_stale_after},
        "evals": hist.evals,
        "final_loss": hist.evals[-1]["mean"] if hist.evals else None,
        "per_lang": hist.evals[-1]["per_lang"] if hist.evals else None,
        "tokens": hist.tokens,
        "comm_bytes": hist.comm_bytes,
        "final_time": hist.final_time,
        "staleness": [a["staleness"] for a in hist.arrivals],
        "arrival_workers": [a["worker_id"] for a in hist.arrivals],
        "n_dropped": sum(1 for a in hist.arrivals if a.get("dropped")),
        "wall_seconds": time.time() - t0,
    }
    if budget is not None:
        out["budget"] = {"kind": budget.kind, "amount": budget.amount}
    if rec is not None:
        out["telemetry"] = rec.write_jsonl(telemetry_path)
        out["telemetry_summary"] = rec.summary()
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out
