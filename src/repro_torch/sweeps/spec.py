"""Declarative sweep specs: the paper's ablation grid as data.

Port of ``repro/sweeps/spec.py``: the same specs, the same three
registered sweeps, and for each the same cell ids and derived
``Scenario``s as the reference's.

A ``SweepSpec`` names a grid of (method x scenario x hyperparameter-axis
x budget) cells. Every cell compiles to a derived ``Scenario`` (method
swapped in with its Table-3 defaults, axis overrides applied, outer-step
cap raised so the BUDGET is the binding stopping rule) plus an engine
``Budget``; the runner (``repro_torch.sweeps.runner``) executes cells
through the port's result cache (``repro_torch.sweeps.cache``) with
telemetry streaming, and the report generator
(``repro_torch.sweeps.report``) renders the paper-style comparison tables
from the results.

Budget kinds (the paper's two headline comparisons + plain steps):

  fixed_tokens     every method sees the same token count (Table 2 left)
  fixed_wallclock  every method gets the same clock horizon (Table 2
                   right — where asynchrony actually pays)
  outer_steps      classic fixed-step run (analysis sweeps)
"""
from __future__ import annotations

import itertools
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.async_engine.engine import Budget
from repro_torch.scenarios.spec import Scenario

# Scenario fields a method swap must reset so the incoming method's
# Table-3 defaults apply instead of the base scenario's tuning.
_METHOD_DEFAULT_FIELDS = dict(outer_lr=None, momentum=None,
                              weight_factor=None, lookahead_init=None)


@dataclass(frozen=True)
class SweepAxis:
    """One hyperparameter axis: a Scenario field swept over values."""
    key: str
    values: Tuple[Any, ...]

    def __post_init__(self):
        assert self.values, "empty axis"
        assert self.key in Scenario.__dataclass_fields__, self.key


@dataclass(frozen=True)
class BudgetSpec:
    """Stopping rule of one grid slice."""
    kind: str                        # Budget.KINDS + "outer_steps"
    amount: float

    def __post_init__(self):
        assert self.kind in (*Budget.KINDS, "outer_steps"), self.kind
        assert self.amount > 0, self.amount

    def to_budget(self) -> Optional[Budget]:
        if self.kind == "outer_steps":
            return None
        return Budget(self.kind, self.amount)

    @property
    def label(self) -> str:
        short = {"fixed_tokens": "tok", "fixed_wallclock": "sec",
                 "outer_steps": "steps"}[self.kind]
        amt = int(self.amount) if float(self.amount).is_integer() \
            else self.amount
        return f"{short}{amt}"


@dataclass(frozen=True)
class SweepCell:
    """One fully-resolved grid cell, ready to run."""
    cell_id: str
    scenario: Scenario               # derived spec (method/axes applied)
    base: str                        # base scenario name
    method: str
    budget: BudgetSpec
    overrides: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"cell_id": self.cell_id, "base": self.base,
                "method": self.method,
                "budget": {"kind": self.budget.kind,
                           "amount": self.budget.amount},
                "overrides": dict(self.overrides)}


def _slug(v: Any) -> str:
    return re.sub(r"[^\w.]+", "-", str(v)).strip("-")


@dataclass(frozen=True)
class SweepSpec:
    name: str
    description: str = ""
    methods: Tuple[str, ...] = ("heloco",)
    scenarios: Tuple[str, ...] = ("paper_hetero_severe",)
    budgets: Tuple[BudgetSpec, ...] = (BudgetSpec("outer_steps", 12),)
    axes: Tuple[SweepAxis, ...] = ()
    outer_cap: int = 64              # step cap when a budget is binding
    baseline: str = ""               # %-comparison anchor (default: first
    # method of the spec)
    eval_every: int = 0              # 0 -> the derived scenario's cadence
    telemetry: bool = True

    def __post_init__(self):
        assert self.methods and self.scenarios and self.budgets

    @property
    def baseline_method(self) -> str:
        from repro_torch.core import methods as outer_methods
        return outer_methods.canonical(self.baseline or self.methods[0])

    def cells(self) -> List[SweepCell]:
        """Enumerate the full grid, validating every base scenario."""
        from repro_torch.scenarios import registry
        out: List[SweepCell] = []
        combos = list(itertools.product(*(ax.values for ax in self.axes))) \
            or [()]
        for budget in self.budgets:
            for base_name in self.scenarios:
                base = registry.get_scenario(base_name)
                if base.failures or base.elastic:
                    raise ValueError(
                        f"sweep base scenario {base_name!r} carries a "
                        "failure/elastic schedule; budgeted cached runs "
                        "do not support those")
                for method in self.methods:
                    for combo in combos:
                        overrides = {ax.key: v
                                     for ax, v in zip(self.axes, combo)}
                        steps = (int(budget.amount)
                                 if budget.kind == "outer_steps"
                                 else max(self.outer_cap, base.outer_steps))
                        parts = [self.name, budget.label, base_name, method]
                        parts += [f"{k}-{_slug(v)}"
                                  for k, v in overrides.items()]
                        cell_id = "__".join(parts)
                        scn = base.overridden(
                            name=cell_id, method=method,
                            outer_steps=steps,
                            **_METHOD_DEFAULT_FIELDS, **overrides)
                        out.append(SweepCell(
                            cell_id=cell_id, scenario=scn, base=base_name,
                            method=scn.method, budget=budget,
                            overrides=overrides))
        ids = [c.cell_id for c in out]
        assert len(set(ids)) == len(ids), "duplicate sweep cell ids"
        return out


# ---------------------------------------------------------------------------
# Named sweeps (the enumerable ablation grids; python -m repro_torch.sweeps)
# ---------------------------------------------------------------------------

_SWEEPS: Dict[str, SweepSpec] = {}


def register(spec: SweepSpec) -> SweepSpec:
    if spec.name in _SWEEPS:
        raise ValueError(f"duplicate sweep name {spec.name!r}")
    _SWEEPS[spec.name] = spec
    return spec


def get_sweep(name: str) -> SweepSpec:
    try:
        return _SWEEPS[name]
    except KeyError:
        raise KeyError(f"unknown sweep {name!r}; registered: "
                       f"{', '.join(_SWEEPS)}") from None


def names() -> List[str]:
    return list(_SWEEPS)


def all_sweeps() -> List[SweepSpec]:
    return list(_SWEEPS.values())


register(SweepSpec(
    name="smoke",
    description="CI-sized 2-method x 2-scenario grid under both paper "
                "budgets; produces the comparison tables + the "
                "staleness-alignment artifact in a couple of minutes.",
    methods=("heloco", "nesterov"),
    scenarios=("paper_hetero_severe", "noniid_dirichlet"),
    budgets=(BudgetSpec("fixed_tokens", 512),
             BudgetSpec("fixed_wallclock", 12.0)),
    outer_cap=24, baseline="nesterov"))

register(SweepSpec(
    name="paper_table2",
    description="Every registered async method on the paper's severe-"
                "heterogeneity and Dirichlet non-IID scenarios at a fixed "
                "token AND a fixed wall-clock budget (Table 2 protocol).",
    methods=("heloco", "mla", "nesterov", "delayed_nesterov", "dcasgd",
             "fedbuff", "poly_stale"),
    scenarios=("paper_hetero_severe", "noniid_dirichlet", "drop_stale"),
    budgets=(BudgetSpec("fixed_tokens", 4096),
             BudgetSpec("fixed_wallclock", 120.0)),
    outer_cap=96, baseline="nesterov"))

register(SweepSpec(
    name="staleness_analysis",
    description="Section-5 update-quality analysis: HeLoCo vs MLA vs "
                "plain Nesterov over a staleness-inducing pace profile, "
                "with the drop threshold swept (App. A.6).",
    methods=("heloco", "mla", "nesterov"),
    scenarios=("paper_hetero_severe",),
    budgets=(BudgetSpec("outer_steps", 24),),
    axes=(SweepAxis("drop_stale_after", (None, 2)),),
    baseline="nesterov"))
