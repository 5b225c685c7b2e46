"""Golden-trace verification of registered scenarios on the port.

Port of ``repro/scenarios/trace.py``. A trace is what a scenario run
promises to reproduce: the arrival sequence ``(outer_step, wid, s_i,
staleness, lang, rho, sim_time, dropped)``, the eval curve, the token and
communication counts, and a SHA-256 digest of the final parameters with a
per-leaf ``[sum, l2]`` fingerprint, both over the reference's canonical
leaf order (``jax.tree_util.keystr`` strings, sorted), so bridged bits give
the reference's digest.

The goldens' digests, fingerprints and evals come from the reference's own
initial draw, which the port cannot reproduce from a seed, so ``verify``
holds a port run to these fields:

  exact (sim, and the deterministic wall-clock runtime)
      arrivals, ``tokens``, ``comm_bytes`` and ``final_time`` equal to the
      golden's, and as many evals;
  cross_engine (a sim scenario replayed on the deterministic runtime)
      the same, and the replay's fingerprint within ``_cmp_fingerprint``'s
      rtol 1e-5 and atol 1e-6 of the port's own sim run of the scenario
      from the same initial parameters (whether the digests are equal too
      is reported in ``details``);
  banded (the free-running runtime)
      the arrival count equal, and the final eval mean, tokens,
      communication and mean staleness inside ``FREE_BANDS``.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.scenarios.spec import Scenario

SCHEMA_VERSION = 1
GOLDEN_DIR = Path(__file__).resolve().parents[3] / "results" / "golden"
# where the port records traces: the reference's committed goldens under
# GOLDEN_DIR are never written
RECORD_DIR = GOLDEN_DIR.parent / "torch_golden"

# tolerance bands of a free-running (not exact) scenario
FREE_BANDS = {
    "final_mean_abs": 0.75,          # final eval mean loss, absolute
    "tokens_rel": 0.5,
    "comm_bytes_rel": 0.5,
    "staleness_mean_abs": 3.0,
}


# ---------------------------------------------------------------------------
# Canonical parameter digests
# ---------------------------------------------------------------------------

def keystr(path: str) -> str:
    """The reference's ``jax.tree_util.keystr`` of a nested-dict leaf given
    by its ``/``-joined path: ``['blocks_list']['layer_00']['norm1']['bias']``."""
    return "".join(f"[{k!r}]" for k in path.split("/"))


def _canonical_leaves(params: Mapping[str, Any]):
    return sorted(((keystr(p), v) for p, v in params.items()),
                  key=lambda kv: kv[0])


def _host(leaf, dtype) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", torch.float32).numpy()
    return np.asarray(leaf, dtype=dtype)


def param_digest(params: Mapping[str, Any]) -> str:
    """SHA-256 over each leaf's path string, shape and fp32 bytes, in
    canonical order."""
    h = hashlib.sha256()
    for path, leaf in _canonical_leaves(params):
        arr = _host(leaf, np.float32)
        h.update(path.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def param_fingerprint(params: Mapping[str, Any]) -> Dict[str, List[float]]:
    """Per-leaf [sum, l2] in float64: lets a comparison hold numerics to a
    tolerance where the digest is all or nothing."""
    out = {}
    for path, leaf in _canonical_leaves(params):
        arr = _host(leaf, np.float64)
        out[path] = [float(arr.sum()), float(np.sqrt((arr ** 2).sum()))]
    return out


# ---------------------------------------------------------------------------
# Running a scenario into a trace document
# ---------------------------------------------------------------------------

def arrival_rows(hist) -> List[list]:
    """The golden's arrival rows: (outer_step, wid, s_i, staleness, lang,
    rho, sim_time, dropped), through JSON as the golden stores them."""
    return json.loads(json.dumps([
        [a["outer_step"], a["worker_id"], a["outer_step"] - 1 - a["staleness"],
         a["staleness"], a["lang"], a["rho"], a["sim_time"],
         bool(a["dropped"])] for a in hist.arrivals]))


def run_scenario(scn: Scenario, device="cuda",
                 init_params: Optional[Mapping[str, np.ndarray]] = None,
                 telemetry=None, tracer=None):
    """Build and run a scenario on ``device`` (from ``init_params`` when
    given) with its golden's eval cadence; returns (engine, history).
    ``telemetry`` (a ``TelemetryRecorder``) and ``tracer`` (an
    ``obs.spans.SpanTracer``) observe the run; over worker processes with
    either on, a child that never shipped an obs frame fails it
    (``assert_child_reports``)."""
    from repro_torch.async_engine.engine import make_eval_fn
    eng = scn.build(device=device, init_params=init_params,
                    telemetry=telemetry, tracer=tracer)
    hist = eng.run(eval_every=scn.eval_cadence,
                   eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    if ((telemetry is not None or tracer is not None)
            and hasattr(eng, "assert_child_reports")):
        eng.assert_child_reports()
    return eng, hist


def run_trace(scn: Scenario, device="cuda",
              init_params: Optional[Mapping[str, np.ndarray]] = None,
              telemetry=None, tracer=None) -> Dict[str, Any]:
    """Run the scenario (``run_scenario``, with ``telemetry`` and
    ``tracer`` observing it) and collect its trace document; a wall-clock
    run adds its ``stats_summary()`` as "stats". Observation must not
    change the document."""
    eng, hist = run_scenario(scn, device, init_params, telemetry, tracer)
    params = eng.server.state.params
    doc = {
        "schema": SCHEMA_VERSION,
        "scenario": scn.to_dict(),
        "engine": scn.engine,
        "mode": scn.mode,
        "exact": scn.exact,
        "arrivals": arrival_rows(hist),
        "evals": hist.evals,
        "tokens": int(hist.tokens),
        "comm_bytes": int(hist.comm_bytes),
        "final_time": float(hist.final_time),
        "param_digest": param_digest(params),
        "param_fingerprint": param_fingerprint(params),
    }
    if hasattr(eng, "stats_summary"):
        doc["stats"] = eng.stats_summary()
    # through JSON, as a golden stores it
    return json.loads(json.dumps(doc, default=str))


def golden_path(name: str, golden_dir=GOLDEN_DIR) -> Path:
    return Path(golden_dir) / f"{name}.json"


def load_golden(name: str, golden_dir=GOLDEN_DIR) -> Dict[str, Any]:
    return json.loads(golden_path(name, golden_dir).read_text())


def refused_dir(golden_dir) -> bool:
    """True when ``golden_dir`` lies under the reference's committed goldens
    (``results/golden``, from the repository's root or from the working
    directory)."""
    path = Path(golden_dir).resolve()
    return any(path == ref or ref in path.parents
               for ref in {GOLDEN_DIR.resolve(),
                           Path("results", "golden").resolve()})


def record(scn: Scenario, golden_dir=RECORD_DIR, device="cuda") -> Path:
    """Run ``scn`` on ``device`` and write its trace as
    ``<golden_dir>/<name>.json`` in the reference's golden format (keys
    sorted, indent 1; a wall-clock run's stats are not part of it).
    Raises ValueError, writing nothing, for a directory under the
    reference's goldens."""
    if refused_dir(golden_dir):
        raise ValueError(f"{golden_dir} holds the reference's goldens; "
                         f"record to {RECORD_DIR}")
    doc = run_trace(scn, device)
    doc.pop("stats", None)
    os.makedirs(golden_dir, exist_ok=True)
    path = golden_path(scn.name, golden_dir)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------

@dataclass
class VerifyResult:
    name: str
    ok: bool
    failures: List[str] = field(default_factory=list)
    details: Dict[str, Any] = field(default_factory=dict)

    def report(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        return "\n".join([f"[{status}] {self.name}"]
                         + [f"    - {f}" for f in self.failures])


def _cmp_arrivals(fails: List[str], got: List[List[Any]],
                  want: List[List[Any]]):
    if len(got) != len(want):
        fails.append(f"arrival count: got {len(got)}, golden {len(want)}")
        return
    labels = ("outer_step", "wid", "s_i", "staleness", "lang", "rho",
              "sim_time", "dropped")
    for i, (g, w) in enumerate(zip(got, want)):
        for lab, gv, wv in zip(labels, g, w):
            if gv != wv:
                fails.append(f"arrival {i} {lab}: got {gv!r}, "
                             f"golden {wv!r}")
                if len(fails) > 12:
                    fails.append("... (diff truncated)")
                    return


def _cmp_counts(fails: List[str], got: Dict, want: Dict,
                keys=("tokens", "comm_bytes", "final_time")):
    """Arrivals and ``keys`` exactly; as many evals."""
    _cmp_arrivals(fails, got["arrivals"], want["arrivals"])
    for key in keys:
        if got[key] != want[key]:
            fails.append(f"{key}: got {got[key]!r}, golden {want[key]!r}")
    if len(got["evals"]) != len(want["evals"]):
        fails.append(f"eval count: got {len(got['evals'])}, golden "
                     f"{len(want['evals'])}")


def _cmp_fingerprint(fails: List[str], got: Dict, want: Dict,
                     rtol: float = 1e-5, atol: float = 1e-6):
    if set(got) != set(want):
        fails.append(f"fingerprint leaves differ: "
                     f"{sorted(set(got) ^ set(want))[:4]}")
        return
    bad = [(path, got[path], wv) for path, wv in want.items()
           if not np.allclose(got[path], wv, rtol=rtol, atol=atol)]
    for path, gv, wv in bad[:4]:
        fails.append(f"fingerprint[{path}]: got {gv}, want {wv}")
    if len(bad) > 4:
        fails.append(f"... {len(bad) - 4} more fingerprint mismatches")


def _verify_banded(fails: List[str], got: Dict, want: Dict,
                   bands: Dict[str, float]):
    if len(got["arrivals"]) != len(want["arrivals"]):
        fails.append(f"arrival count: got {len(got['arrivals'])}, "
                     f"golden {len(want['arrivals'])}")
    gm = got["evals"][-1]["mean"] if got["evals"] else float("nan")
    wm = want["evals"][-1]["mean"] if want["evals"] else float("nan")
    if not abs(gm - wm) <= bands["final_mean_abs"]:
        fails.append(f"final eval mean drifted: got {gm:.4f}, golden "
                     f"{wm:.4f} (band +-{bands['final_mean_abs']})")
    for key, band_key in (("tokens", "tokens_rel"),
                          ("comm_bytes", "comm_bytes_rel")):
        g, w = got[key], want[key]
        if w and abs(g - w) > bands[band_key] * w:
            fails.append(f"{key}: got {g}, golden {w} "
                         f"(rel band {bands[band_key]})")
    g_tau = float(np.mean([a[3] for a in got["arrivals"]])
                  if got["arrivals"] else 0.0)
    w_tau = float(np.mean([a[3] for a in want["arrivals"]])
                  if want["arrivals"] else 0.0)
    if abs(g_tau - w_tau) > bands["staleness_mean_abs"]:
        fails.append(f"mean staleness: got {g_tau:.2f}, golden {w_tau:.2f} "
                     f"(band +-{bands['staleness_mean_abs']})")


def verify(scn: Scenario, golden_dir=GOLDEN_DIR, *,
           cross_engine: bool = False, device="cuda",
           transport: Optional[str] = None,
           fresh: Optional[Dict[str, Any]] = None,
           obs: bool = False) -> VerifyResult:
    """Run ``scn`` on ``device`` and compare it with its committed golden
    (see the module's docstring for which fields are held to what).

    ``cross_engine=True`` (sim scenarios only) replays the scenario on the
    deterministic wall-clock runtime and also runs it on the simulator.
    ``transport`` overrides the wall-clock backend of the fresh run only
    ("socket": worker processes); the golden's recorded spec is compared
    untouched, since the backend must not change the trace. ``fresh``
    injects a precomputed trace document of the run (a testing hook).
    ``obs=True`` runs the fresh run with the whole observability stack on
    (a ``TelemetryRecorder`` with a live sink, a "runtime" record at the
    scenario's cadence, a ``SpanTracer`` and, over worker processes, the
    children's obs frames) and holds it to the same fields, and its trace
    to ``validate_chrome_trace`` with at least one span: observation must
    not change the run."""
    path = golden_path(scn.name, golden_dir)
    tag = (" [cross-engine wallclock]" if cross_engine else "") + (
        f" [transport={transport}]" if transport else "") + (
        " [obs]" if obs else "")
    res = VerifyResult(name=scn.name + tag, ok=True)

    def fresh_run(run_scn: Scenario) -> Dict[str, Any]:
        if fresh is not None:
            return fresh
        if not obs:
            return run_trace(run_scn, device)
        import tempfile
        from repro_torch.obs.spans import SpanTracer, validate_chrome_trace
        from repro_torch.telemetry import TelemetryRecorder
        tr = SpanTracer()
        with tempfile.TemporaryDirectory() as td:
            rec = TelemetryRecorder(sink=os.path.join(td, "live.jsonl"))
            try:
                got = run_trace(run_scn, device, telemetry=rec, tracer=tr)
            finally:
                rec.close()
        for p in validate_chrome_trace(tr.to_chrome())[:4]:
            res.failures.append(f"obs trace invalid: {p}")
        if len(tr) == 0:
            res.failures.append("obs stack produced no trace spans")
        res.details["trace_events"] = len(tr)
        return got

    if not path.exists():
        res.ok = False
        res.failures.append(f"missing golden trace {path}")
        return res
    want = load_golden(scn.name, golden_dir)
    if want.get("schema") != SCHEMA_VERSION:
        res.failures.append(f"golden schema {want.get('schema')} != "
                            f"{SCHEMA_VERSION}")
    if want.get("scenario") != json.loads(json.dumps(scn.to_dict())):
        res.failures.append("the registered scenario's spec differs from "
                            "the golden's")
    if cross_engine and scn.engine != "sim":
        res.failures.append("cross-engine verify only applies to sim "
                            "scenarios")
    if (transport and transport != scn.transport and not cross_engine
            and scn.engine != "wallclock"):
        res.failures.append("a transport override of a sim scenario needs "
                            "cross_engine=True (the socket backend is the "
                            "wall-clock runtime's)")
    if res.failures:
        res.ok = False
        return res

    if cross_engine:
        replay = scn.overridden(engine="wallclock", mode="deterministic",
                                transport=transport or scn.transport)
        got = fresh_run(replay)
        twin = run_trace(scn, device)
        _cmp_counts(res.failures, got, want)
        _cmp_fingerprint(res.failures, got["param_fingerprint"],
                         twin["param_fingerprint"])
        res.details["sim_digest"] = twin["param_digest"]
        res.details["digest_equal"] = (got["param_digest"]
                                       == twin["param_digest"])
    else:
        run_scn = (scn.overridden(transport=transport)
                   if transport and transport != scn.transport else scn)
        got = fresh_run(run_scn)
        if scn.exact:
            _cmp_counts(res.failures, got, want)
        else:
            _verify_banded(res.failures, got, want, FREE_BANDS)
    res.ok = not res.failures
    res.details.update(golden=str(path), got_digest=got["param_digest"],
                       stats=got.get("stats"))
    return res


def write_diff(res: VerifyResult, diff_dir) -> str:
    """Write a failure report as JSON (the CI artifact)."""
    os.makedirs(diff_dir, exist_ok=True)
    slug = re.sub(r"[^\w.-]+", "_", res.name).strip("_")
    path = os.path.join(diff_dir, f"{slug}.diff.json")
    with open(path, "w") as f:
        json.dump({"name": res.name, "ok": res.ok,
                   "failures": res.failures, "details": res.details},
                  f, indent=1, default=str)
    return path
