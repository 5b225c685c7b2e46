"""Budgeted sweeps over the scenario grid: the port of ``repro/sweeps``.

The paper's headline evidence is comparative at FIXED budgets: every
method gets the same token count (Table 2, fixed-token) or the same
clock horizon (fixed-wallclock, the virtual clock of the sim engine), and
Section 5 analyzes update quality along the way. This package makes that
grid declarative:

    from repro_torch.sweeps import SweepSpec, BudgetSpec, run_sweep
    run_sweep("smoke")                        # registered grid, on cuda
    run_sweep("smoke", device="cpu")
    run_sweep(SweepSpec(name="mine", methods=("heloco", "mla"),
                        scenarios=("paper_hetero_severe",),
                        budgets=(BudgetSpec("fixed_tokens", 4096),)))

CLI: ``python -m repro_torch.sweeps {list, run, report} ...``.
"""
from repro_torch.sweeps.report import (               # noqa: F401
    alignment_curves, comparison_tables, generate_report,
)
from repro_torch.sweeps.runner import SWEEP_DIR, run_sweep  # noqa: F401
from repro_torch.sweeps.spec import (                 # noqa: F401
    BudgetSpec, SweepAxis, SweepCell, SweepSpec, all_sweeps, get_sweep,
    names, register,
)
