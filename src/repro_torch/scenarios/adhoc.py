"""The benchmark dialect of ad-hoc runs: the method aliases with their
Table-3 defaults, and ``scenario_for``, which compiles a pace profile and
flags into a ``Scenario``.

A copy of what ``benchmarks/common.py`` holds (``METHODS``,
``scenario_for``), for the port's examples, which import no benchmark
harness; a test holds the two equal.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import methods as outer_methods
from repro_torch.scenarios.spec import Scenario

# paper Table 3 (Appendix A.5): benchmark-dialect names ("async-heloco") ->
# the raw method and its defaults, from the method registry's aliases
METHODS = {alias: dict(method=raw, **outer_methods.get(raw).defaults())
           for alias, raw in outer_methods.alias_table().items()}


def scenario_for(paces: Sequence[float], *, method: str, non_iid: bool,
                 outer_steps: int, inner_steps: int, dylu: bool = False,
                 seed: int = 0, compression: str = "none",
                 drop_stale_after: Optional[int] = None,
                 shard_assignment: str = "fixed",
                 mixture_alpha: Optional[float] = None,
                 batch_size: int = 4, seq_len: int = 64,
                 name: str = "bench", **scenario_kw) -> Scenario:
    """The benchmark dialect, compiled to a Scenario: ``method`` takes the
    benchmark preset names ("async-heloco", ...) or raw method names
    (``Scenario`` canonicalizes them through the method registry)."""
    return Scenario(
        name=name, method=method,
        n_workers=len(paces),
        worker_paces=tuple(float(p) for p in paces),
        outer_steps=outer_steps, inner_steps=inner_steps,
        batch_size=batch_size, seq_len=seq_len,
        non_iid=non_iid, dylu=dylu, seed=seed,
        compression=compression, drop_stale_after=drop_stale_after,
        shard_assignment=shard_assignment, mixture_alpha=mixture_alpha,
        **scenario_kw)
