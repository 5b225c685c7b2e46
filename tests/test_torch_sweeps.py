"""The port's budgets and sweep layer (ROADMAP A12's ``Budget``, A15's
sweeps) against the reference's.

  * ``Budget`` validates and reads as the reference's;
  * ``fixed_tokens`` and ``fixed_wallclock`` stop the async engine, the
    sync engine (``sync_baseline``) and the batched commit path
    (``commit_batch=4``) at the reference's arrival, tokens and
    ``final_time``; a live budgeted run from the same bits agrees with the
    reference's as ``check_live`` holds it (evals within 1e-4, parameters
    within 5e-4 of each leaf's largest |value|);
  * the three registered sweeps enumerate the reference's cell ids, budgets,
    overrides and derived ``Scenario`` dicts; grid shape, method defaults,
    axes, labels, refused failure schedules and the comparison table's
    percentages as tests/test_sweeps.py holds the reference's;
  * a tiny budgeted sweep end to end on the CPU: each cell stops where the
    reference's tiny sweep's does (arrivals, tokens, final time), its
    telemetry stream and report are written, and a second run comes from
    the cache. Losses differ between the two packages' sweeps: each starts
    from its own fresh initialization (ROADMAP C, init RNG drift), so they
    are compared only through the bridged-bits runs above;
  * the cache key names the device, and a card sweep raises without a GPU.
"""
import json

import pytest
import torch

from repro.async_engine.engine import Budget as JaxBudget
from repro.async_engine.engine import make_engine as jax_make_engine
from repro.async_engine.engine import make_eval_fn as jax_make_eval_fn
from repro.scenarios import registry as jregistry
from repro.sweeps import get_sweep as jax_get_sweep
from repro.sweeps import run_sweep as jax_run_sweep
from repro_torch.async_engine.engine import Budget, make_eval_fn
from repro_torch.scenarios import registry, run
from repro_torch.sweeps import (
    BudgetSpec, SweepAxis, SweepSpec, cache, comparison_tables, get_sweep,
    names, run_sweep,
)
from repro_torch.telemetry import TelemetryRecorder
from test_torch_methods import check_live, one_intra_op_thread  # noqa: F401
from test_torch_server import _flat


def test_budget_validation():
    with pytest.raises(AssertionError):
        Budget("nope", 10)
    with pytest.raises(AssertionError):
        Budget("fixed_tokens", 0)
    b = Budget("fixed_tokens", 100)
    assert b.over_tokens(100) and not b.over_tokens(99)
    assert not b.over_time(1e9)
    w = Budget("fixed_wallclock", 5.0)
    assert w.over_time(5.01) and not w.over_time(5.0)
    assert not w.over_tokens(10 ** 12)
    assert Budget.KINDS == JaxBudget.KINDS


# (scenario, overrides, budget kind, amount): each binds before the run's
# outer_steps. A round of paper_hetero_severe and fedbuff is 64 tokens, a
# barrier round of sync_baseline 192 tokens and 12 s of the clock; the
# batched fedbuff commits same-tick pairs at t = 4 and 8.
BUDGETED = [
    ("paper_hetero_severe", {}, "fixed_tokens", 200),
    ("paper_hetero_severe", {}, "fixed_wallclock", 4.0),
    ("sync_baseline", {}, "fixed_tokens", 200),
    ("sync_baseline", {}, "fixed_wallclock", 30.0),
    ("fedbuff", {"commit_batch": 4}, "fixed_tokens", 300),
    ("fedbuff", {"commit_batch": 4}, "fixed_wallclock", 5.0),
]


@pytest.mark.parametrize("name,overrides,kind,amount", BUDGETED)
def test_budget_stops_where_the_reference_stops(name, overrides, kind,
                                                amount):
    scn = jregistry.get_scenario(name).overridden(**overrides)
    jeng = jax_make_engine(scn)
    eng = registry.get_scenario(name).overridden(**overrides).build(
        device="cpu", init_params=_flat(jeng.server.state.params))
    # one eval, at the stop
    jhist = jeng.run(budget=JaxBudget(kind, amount),
                     eval_fn=jax_make_eval_fn(jeng, batch=scn.eval_batch))
    hist = eng.run(budget=Budget(kind, amount),
                   eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    assert run.arrival_rows(hist) == run.arrival_rows(jhist)
    assert (hist.tokens, hist.final_time) == (jhist.tokens, jhist.final_time)
    assert 0 < len(hist.arrivals) < scn.outer_steps
    if kind == "fixed_tokens":
        assert amount <= hist.tokens
    else:
        assert all(a["sim_time"] <= amount for a in hist.arrivals)
        assert hist.final_time <= amount
    check_live(jeng, jhist, eng, hist)


def _cell_facts(spec):
    return [(c.cell_id, c.base, c.method, c.budget.kind, c.budget.amount,
             c.overrides, json.loads(json.dumps(c.scenario.to_dict())))
            for c in spec.cells()]


@pytest.mark.parametrize("name", ["smoke", "paper_table2",
                                  "staleness_analysis"])
def test_registered_sweep_cells_equal_the_reference(name):
    spec, jspec = get_sweep(name), jax_get_sweep(name)
    assert spec.baseline_method == jspec.baseline_method
    facts = _cell_facts(spec)
    assert facts == _cell_facts(jspec)
    ids = [f[0] for f in facts]
    assert ids and len(set(ids)) == len(ids)


def test_registered_sweep_names():
    assert names() == ["smoke", "paper_table2", "staleness_analysis"]
    with pytest.raises(KeyError):
        run_sweep("not_a_sweep", device="cpu")


def test_smoke_grid_shape_and_method_defaults():
    spec = get_sweep("smoke")
    cells = spec.cells()
    assert len(cells) == (len(spec.methods) * len(spec.scenarios)
                          * len(spec.budgets))
    for c in cells:
        # method swapped in with Table-3 defaults, budget binding
        assert c.scenario.method == c.method
        assert c.scenario.outer_lr is None
        assert c.scenario.outer_steps >= spec.outer_cap
        assert c.scenario.name == c.cell_id
    assert spec.baseline_method == "nesterov"


def test_axes_expand_the_grid_and_validate():
    spec = SweepSpec(name="t", methods=("heloco",),
                     scenarios=("paper_hetero_severe",),
                     budgets=(BudgetSpec("outer_steps", 4),),
                     axes=(SweepAxis("drop_stale_after", (None, 2)),
                           SweepAxis("inner_steps", (1, 2, 3))))
    cells = spec.cells()
    assert len(cells) == 6
    assert {c.scenario.inner_steps for c in cells} == {1, 2, 3}
    assert any(c.scenario.drop_stale_after == 2 for c in cells)
    # outer_steps budget -> exact step count, no Budget object
    assert all(c.scenario.outer_steps == 4 for c in cells)
    assert all(c.budget.to_budget() is None for c in cells)
    with pytest.raises(AssertionError):
        SweepAxis("not_a_scenario_field", (1,))


def test_budget_spec_labels_and_conversion():
    assert BudgetSpec("fixed_tokens", 512).label == "tok512"
    assert BudgetSpec("fixed_wallclock", 12.0).label == "sec12"
    assert BudgetSpec("outer_steps", 24).label == "steps24"
    b = BudgetSpec("fixed_tokens", 512).to_budget()
    assert isinstance(b, Budget) and b.kind == "fixed_tokens"
    with pytest.raises(AssertionError):
        BudgetSpec("wat", 1)


@pytest.mark.parametrize("base", ["crash_rejoin", "elastic_membership"])
def test_failure_scenarios_rejected(base):
    spec = SweepSpec(name="t", methods=("heloco",), scenarios=(base,),
                     budgets=(BudgetSpec("fixed_tokens", 128),))
    with pytest.raises(ValueError):
        spec.cells()


@pytest.mark.parametrize("name", ["crash_rejoin", "trace_paced"])
def test_cached_runs_refuse_failure_schedules(name, tmp_path, monkeypatch):
    """A scenario's own crashes, or those of its pace trace."""
    monkeypatch.setattr(cache, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="failure/elastic"):
        cache.run_cached_scenario(name, registry.get_scenario(name),
                                  device="cpu")


def test_cache_key_names_the_device():
    scn = registry.get_scenario("paper_hetero_severe")
    budget = Budget("fixed_tokens", 512)
    keys = {cache._key(scn, 3, budget=budget, device=d)
            for d in ("cpu", "cuda")}
    assert len(keys) == 2
    assert cache._key(scn, 3, budget=budget, device="cpu") == \
        cache._key(scn, 3, budget=budget, device="cpu")


def test_card_sweep_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_sweep("smoke", out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        cache.run_cached_scenario(
            "x", registry.get_scenario("paper_hetero_severe"))
    assert not list(tmp_path.iterdir())


def _fake_doc():
    b = {"kind": "fixed_tokens", "amount": 256}

    def cell(method, loss):
        return {"cell_id": f"x__{method}", "base": "paper_hetero_severe",
                "method": method, "budget": b, "overrides": {},
                "final_loss": loss, "per_lang": {"de": loss},
                "tokens": 256, "final_time": 10.0, "arrivals": 4,
                "n_dropped": 0, "telemetry": None}
    return {"sweep": "x", "baseline": "nesterov",
            "methods": ["heloco", "nesterov"],
            "scenarios": ["paper_hetero_severe"],
            "budgets": [b],
            "cells": [cell("heloco", 3.8), cell("nesterov", 4.0)],
            "n_cells": 2, "wall_seconds": 1.0}


def test_comparison_table_percentages():
    tables = comparison_tables(_fake_doc())
    assert len(tables) == 1
    rows = tables[0]["rows"]
    col = "paper_hetero_severe"
    assert rows["nesterov"][col]["delta_pct"] is None      # baseline
    assert abs(rows["heloco"][col]["delta_pct"] - (-5.0)) < 1e-9


TINY = SweepSpec(
    name="tiny", methods=("heloco", "nesterov"),
    scenarios=("paper_hetero_severe",),
    budgets=(BudgetSpec("fixed_tokens", 192),),
    outer_cap=12, baseline="nesterov")
STOPS = ("cell_id", "method", "budget", "tokens", "final_time", "arrivals",
         "n_dropped")


def test_tiny_sweep_end_to_end_stops_where_the_reference_stops(
        tmp_path, monkeypatch):
    from benchmarks import common
    from repro.sweeps import SweepSpec as JaxSweepSpec
    from repro.sweeps import BudgetSpec as JaxBudgetSpec
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path / "ref_runs"))
    monkeypatch.setattr(cache, "RESULTS_DIR", str(tmp_path / "runs"))
    jspec = JaxSweepSpec(
        name="tiny", methods=TINY.methods, scenarios=TINY.scenarios,
        budgets=tuple(JaxBudgetSpec(b.kind, b.amount) for b in TINY.budgets),
        outer_cap=TINY.outer_cap, baseline=TINY.baseline)
    jdoc = jax_run_sweep(jspec, out_dir=str(tmp_path / "ref"), verbose=False)
    doc = run_sweep(TINY, out_dir=str(tmp_path), verbose=False, device="cpu")
    assert doc["n_cells"] == jdoc["n_cells"] == 2 and doc["device"] == "cpu"
    assert [{k: r[k] for k in STOPS} for r in doc["cells"]] == \
        [{k: r[k] for k in STOPS} for r in jdoc["cells"]]
    for row in doc["cells"]:
        # the budget stopped the run (192 tokens = 3 rounds)
        assert 192 <= row["tokens"] < 192 + 64
        assert row["final_loss"] is not None
        rec = TelemetryRecorder.read_jsonl(row["telemetry"])
        assert len(rec.arrivals()) == row["arrivals"]
        assert rec.meta.method == row["method"]
        assert rec.meta.scenario == row["cell_id"]
    sweep_dir = tmp_path / "tiny"
    report = (sweep_dir / "report.md").read_text()
    assert "fixed token budget" in report
    assert "baseline" in report and "`heloco`" in report
    tables = json.loads((sweep_dir / "tables.json").read_text())["tables"]
    assert [t["label"] for t in tables] == [
        t["label"] for t in comparison_tables(jdoc)]
    curves = json.loads((sweep_dir / "staleness_alignment.json"
                         ).read_text())["curves"]
    assert curves.get("heloco"), "no alignment curve from telemetry"
    # a second invocation comes from the cache
    doc2 = run_sweep(TINY, out_dir=str(tmp_path), verbose=False,
                     device="cpu")
    assert [r["final_loss"] for r in doc2["cells"]] == \
        [r["final_loss"] for r in doc["cells"]]
    assert doc2["wall_seconds"] < doc["wall_seconds"] / 2
