"""Declarative scenario specs: one frozen dataclass says how a run is built.

Port of ``repro/scenarios/spec.py``. Every field, default and JSON form is
the reference's, so ``Scenario.to_dict()`` equals the reference's (and the
``scenario`` dict of each committed golden) field for field. ``build()``
hands back a port engine on the device it is given; a scenario that asks
for an axis the port does not run yet raises ``NotImplementedError``
naming its ROADMAP item before anything runs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.async_engine.faults import FaultSpec
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (
    HeLoCoConfig, InnerOptConfig, OuterOptConfig, RunConfig,
)
from repro_torch.core import methods as outer_methods

ENGINES = ("sim", "wallclock")
MODES = ("deterministic", "free")
TRANSPORTS = ("inproc", "socket")
TOPOLOGIES = ("hub", "ring", "gossip")


@dataclass(frozen=True)
class FailureSpec:
    """A worker crash (in-flight round lost) with a scheduled rejoin."""
    time: float
    wid: int
    restart_delay: float = 60.0


@dataclass(frozen=True)
class ElasticSpec:
    """Elastic membership change: a worker joins or leaves at `time`."""
    time: float
    action: str                      # "join" | "leave"
    wid: int
    pace: float = 1.0
    lang: Optional[int] = None

    def __post_init__(self):
        if self.action not in ("join", "leave"):
            raise ValueError(f"elastic action {self.action!r}")


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class Scenario:
    """One named cell of the paper's scenario grid."""
    name: str
    description: str = ""
    # -- model -------------------------------------------------------------
    arch: str = "tinygpt-15m"
    smoke: bool = True               # reduced() CPU-friendly variant
    # -- engine ------------------------------------------------------------
    engine: str = "sim"              # "sim" | "wallclock"
    mode: str = "deterministic"      # wallclock commit order
    pace_scale: float = 0.0          # wallclock free-running throttle
    transport: str = "inproc"        # wallclock backend: "inproc" | "socket"
    topology: str = "hub"            # "hub" | "ring" | "gossip" (NoLoCo)
    # -- schedule / heterogeneity -------------------------------------------
    n_workers: int = 4
    worker_paces: Tuple[float, ...] = (1.0,)     # cycled to n_workers
    inner_steps: int = 2
    outer_steps: int = 12
    batch_size: int = 2
    seq_len: int = 16
    commit_batch: int = 1            # arrivals coalesced per commit
    batch_rampup: Optional[int] = None           # per-round batch ramp target
    pace_trace: str = ""             # committed straggler/churn trace file
    non_iid: bool = True
    mixture_alpha: Optional[float] = None        # Dirichlet language mixture
    shard_assignment: str = "fixed"              # "fixed" | "flexible"
    dylu: bool = False
    # -- outer optimizer -----------------------------------------------------
    method: str = "heloco"
    outer_lr: Optional[float] = None             # None -> METHOD_TABLE default
    momentum: Optional[float] = None
    weight_factor: Optional[str] = None
    lookahead_init: Optional[bool] = None
    heloco: HeLoCoConfig = field(default_factory=HeLoCoConfig)
    compression: str = "none"                    # none | int8 | topk
    topk_ratio: float = 0.1
    error_feedback: bool = True
    drop_stale_after: Optional[int] = None
    delay_weighting: bool = False
    # -- inner optimizer -----------------------------------------------------
    inner_lr: float = 3e-3
    # -- failure / elastic schedules ------------------------------------------
    failures: Tuple[FailureSpec, ...] = ()
    elastic: Tuple[ElasticSpec, ...] = ()
    # -- unreliable delivery (chaos scenarios; wallclock engine only) ---------
    faults: Optional[FaultSpec] = None
    # -- eval / reproducibility ----------------------------------------------
    eval_every: int = 0              # 0 -> outer_steps // 4 (min 1)
    eval_batch: int = 8
    seed: int = 0
    # -- observability: a runtime telemetry record every N commits when a
    # recorder is attached; observation only, and the port has no recorder
    # yet (ROADMAP A10)
    telemetry_every: int = 0

    def __post_init__(self):
        _check(self.engine in ENGINES, f"engine {self.engine!r}")
        _check(self.mode in MODES, f"mode {self.mode!r}")
        _check(self.transport in TRANSPORTS, f"transport {self.transport!r}")
        _check(self.topology in TOPOLOGIES, f"topology {self.topology!r}")
        _check(self.transport != "socket" or self.engine == "wallclock",
               f"transport='socket' needs engine='wallclock', got "
               f"{self.engine!r}")
        # canonicalize benchmark-dialect aliases; KeyError for unknown ones
        object.__setattr__(self, "method",
                           outer_methods.canonical(self.method))
        _check(self.n_workers >= 1 and bool(self.worker_paces),
               "a scenario needs workers and paces")
        _check(self.topology == "hub"
               or not outer_methods.get(self.method).sync,
               f"topology={self.topology!r} needs an async method, got "
               f"{self.method!r}")
        if self.faults is not None:
            _check(self.engine == "wallclock",
                   f"faults need engine='wallclock', got {self.engine!r}")
            _check(not self.faults.partitions or self.mode == "free",
                   "partition windows require mode='free'")

    # ------------------------------------------------------------ properties
    @property
    def paces(self) -> Tuple[float, ...]:
        if self.pace_trace:
            raise NotImplementedError(
                f"pace_trace={self.pace_trace!r}: trace-replayed paces and "
                "churn are not in the port yet (ROADMAP A11)")
        base = self.worker_paces
        return tuple(base[i % len(base)] for i in range(self.n_workers))

    @property
    def eval_cadence(self) -> int:
        return self.eval_every or max(self.outer_steps // 4, 1)

    # --------------------------------------------------------------- configs
    def model_config(self):
        model = get_config(self.arch)
        return reduced(model) if self.smoke else model

    def outer_config(self) -> OuterOptConfig:
        preset = outer_methods.get(self.method)
        return OuterOptConfig(
            method=self.method,
            outer_lr=(self.outer_lr if self.outer_lr is not None
                      else preset.outer_lr),
            momentum=(self.momentum if self.momentum is not None
                      else preset.momentum),
            weight_factor=self.weight_factor or preset.weight_factor,
            lookahead_init=(self.lookahead_init
                            if self.lookahead_init is not None
                            else preset.lookahead_init),
            heloco=self.heloco,
            compression=self.compression,
            topk_ratio=self.topk_ratio,
            error_feedback=self.error_feedback,
            drop_stale_after=self.drop_stale_after,
            delay_weighting=self.delay_weighting)

    def inner_config(self) -> InnerOptConfig:
        total = self.outer_steps * self.inner_steps
        return InnerOptConfig(lr=self.inner_lr,
                              warmup_steps=max(total // 20, 2),
                              total_steps=total)

    def run_config(self) -> RunConfig:
        return RunConfig(
            model=self.model_config(),
            inner=self.inner_config(),
            outer=self.outer_config(),
            n_workers=self.n_workers,
            inner_steps=self.inner_steps,
            outer_steps=self.outer_steps,
            batch_size=self.batch_size,
            seq_len=self.seq_len,
            worker_paces=self.paces,
            non_iid=self.non_iid,
            mixture_alpha=self.mixture_alpha,
            shard_assignment=self.shard_assignment,
            dylu=self.dylu,
            topology=self.topology,
            commit_batch=self.commit_batch,
            batch_rampup=self.batch_rampup,
            seed=self.seed)

    # ----------------------------------------------------------------- build
    def unported_axes(self) -> Tuple[str, ...]:
        """The axes set here that the port cannot run yet, each with its
        ROADMAP item (empty when ``build`` will run)."""
        from repro_torch.async_engine.engine import unported_axes
        out = []
        if self.engine != "sim":
            out.append(f"engine={self.engine!r} (ROADMAP A13)")
        if self.faults is not None:
            out.append("faults (ROADMAP A13)")
        if self.failures:
            out.append("failures (ROADMAP A7, engine axes)")
        if self.elastic:
            out.append("elastic (ROADMAP A7, engine axes)")
        if self.pace_trace:     # its paces come from the trace file
            out.append(f"pace_trace={self.pace_trace!r} (ROADMAP A11)")
        else:
            out += unported_axes(self.run_config())
        return tuple(out)

    def build(self, device="cuda",
              init_params: Optional[Mapping[str, np.ndarray]] = None):
        """Ready-to-run port engine for this scenario on ``device``.
        ``init_params``: start from these parameters (numpy arrays keyed by
        path) instead of a fresh draw from the seed."""
        missing = self.unported_axes()
        if missing:
            raise NotImplementedError(
                f"scenario {self.name!r} needs what the port does not run "
                f"yet: {'; '.join(missing)}")
        from repro_torch.async_engine.engine import make_engine
        return make_engine(self.run_config(), self.engine, device=device,
                           init_params=init_params)

    # ------------------------------------------------------------- overrides
    def overridden(self, **kw) -> "Scenario":
        """Derived scenario (dataclasses.replace with nested spec support)."""
        if "failures" in kw:
            kw["failures"] = tuple(kw["failures"])
        if "elastic" in kw:
            kw["elastic"] = tuple(kw["elastic"])
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ json
    def to_dict(self) -> Dict[str, Any]:
        """The reference's JSON form: axes added after the first goldens
        are left out at their defaults, so every golden's ``scenario`` dict
        stays as it was recorded."""
        d = dataclasses.asdict(self)
        if self.faults is None:
            d.pop("faults")
        else:
            d["faults"] = self.faults.to_dict()
        if not self.telemetry_every:
            d.pop("telemetry_every")
        if self.transport == "inproc":
            d.pop("transport")
        if self.topology == "hub":
            d.pop("topology")
        if self.commit_batch == 1:
            d.pop("commit_batch")
        if self.batch_rampup is None:
            d.pop("batch_rampup")
        if not self.pace_trace:
            d.pop("pace_trace")
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        d = dict(d)
        d["worker_paces"] = tuple(d.get("worker_paces", (1.0,)))
        d["heloco"] = HeLoCoConfig(**d.get("heloco", {}))
        d["failures"] = tuple(FailureSpec(**f) for f in d.get("failures", ()))
        d["elastic"] = tuple(ElasticSpec(**e) for e in d.get("elastic", ()))
        if d.get("faults") is not None:
            d["faults"] = FaultSpec.from_dict(d["faults"])
        return cls(**d)
