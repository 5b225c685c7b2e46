"""Configs read by the port's training slice.

A copy of the subset of ``repro/configs/base.py`` that the sim engine on
the dense family reads, plus the run-level axes a scenario writes; field
names and defaults are the reference's so a config means the same thing on
both sides.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # the port runs "dense" only
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # the port implements "layernorm"
    norm_eps: float = 1e-5
    mlp_act: str = "swiglu"          # the port implements "gelu" (tanh)
    tied_embeddings: bool = False
    causal: bool = True
    param_dtype: str = "float32"     # master weights
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads:
            raise ValueError((self.n_heads, self.n_kv_heads))


@dataclass(frozen=True)
class HeLoCoConfig:
    """Paper Table 3 defaults (Appendix A.5)."""
    c_ok: float = 0.2
    k_s: float = 0.5
    k_d: float = 1.0
    kappa: float = 3.0
    beta_max: float = 0.5
    eps: float = 1e-8


@dataclass(frozen=True)
class OuterOptConfig:
    method: str = "heloco"
    outer_lr: float = 0.7
    momentum: float = 0.9
    weight_factor: str = "base"      # "base" sqrt(k)/k | "average" 1/k | "one"
    lookahead_init: bool = True      # HeLoCo Eq. 5
    heloco: HeLoCoConfig = field(default_factory=HeLoCoConfig)
    drop_stale_after: Optional[int] = None   # discard if tau > this
    delay_weighting: bool = False            # rho_t = 1/sqrt(1+tau)
    # pseudo-gradient compression: the port runs "none" only (ROADMAP A9)
    compression: str = "none"        # none | int8 | topk
    topk_ratio: float = 0.1
    error_feedback: bool = True


@dataclass(frozen=True)
class InnerOptConfig:
    lr: float = 4e-4
    warmup_steps: int = 50
    total_steps: int = 24_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"         # "cosine" | "constant"


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    inner: InnerOptConfig = field(default_factory=InnerOptConfig)
    outer: OuterOptConfig = field(default_factory=OuterOptConfig)
    n_workers: int = 5
    inner_steps: int = 20            # H
    outer_steps: int = 100           # T
    batch_size: int = 8              # per-worker inner batch
    seq_len: int = 64
    seed: int = 0
    worker_paces: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)  # sec/step
    non_iid: bool = True
    # The axes below are the reference's; the port's engine raises on a
    # value other than the default (see ``async_engine/engine.py``).
    mixture_alpha: Optional[float] = None    # Dirichlet language mixtures
    shard_assignment: str = "fixed"  # "fixed" | "flexible" (App. A.6)
    dylu: bool = False               # Dynamic Local Updates
    topology: str = "hub"            # "hub" | "ring" | "gossip"
    commit_batch: int = 1            # arrivals coalesced per commit
    batch_rampup: Optional[int] = None       # per-round batch ramp target


def reduced(model: ModelConfig) -> ModelConfig:
    """Smoke-test variant of a dense model: same block pattern, tiny dims
    (the dense branch of the reference ``reduced``)."""
    kv = min(model.n_kv_heads, 2)
    return replace(
        model,
        name=model.name + "-smoke",
        n_layers=min(model.n_layers, 4),
        d_model=64,
        n_heads=max(4, kv),
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if model.d_ff else 0,
        vocab_size=128,
        param_dtype="float32",
        compute_dtype="float32",
    )
