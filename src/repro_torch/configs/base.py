"""Configs of the port: architectures, input shapes and run configs.

A copy of ``repro/configs/base.py``'s architecture and shape configs, with
every field and default of the reference, and ``reduced`` (the smoke-test
variant of any architecture); the run-level configs hold the fields the
port's engines read. Field names and defaults are the reference's, so a
config means the same thing on both sides.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
# Block kinds a layer stack may contain.
BLOCK_KINDS = ("attn_mlp", "moe", "mamba2", "mlstm", "slstm")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    shared_expert: bool = False      # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    group_size: int = 2048           # tokens per dispatch group (memory knob)
    dispatch: str = "scatter"        # "scatter" O(T*d) | "einsum" O(T*E*C*d)
    group_mode: str = "scan"         # "scan" (bounded memory, single-host)
    # | "vmap" (all groups vectorized — REQUIRED at scale: scanning over a
    # data-sharded group axis makes GSPMD emit per-group collectives)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block hyperparameters."""
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block hyperparameters (mLSTM + sLSTM)."""
    slstm_at: Tuple[int, ...] = ()   # layer indices that are sLSTM blocks
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv_kernel: int = 4
    chunk_size: int = 64             # mLSTM chunkwise-parallel chunk length


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() provides precomputed embeddings."""
    kind: str = "none"               # "none" | "audio" | "vision"
    n_prefix_tokens: int = 0         # vision: patch tokens prepended
    # audio: the whole sequence is frame embeddings (no token embedding table
    # lookup for inputs; output head still projects to `vocab_size` units).


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention details ---
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    mlp_act: str = "swiglu"          # "swiglu" | "gelu" | "geglu"
    parallel_block: bool = False     # command-r style parallel attn+FFN
    tied_embeddings: bool = False
    causal: bool = True              # encoder-only -> False
    embed_scale: bool = False        # gemma-style sqrt(d_model) input scaling
    # --- block pattern ---
    block_kind: str = "attn_mlp"     # homogeneous kind unless hybrid/ssm
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)
    # zamba2: shared attention block applied every `shared_attn_every` mamba
    # layers (one weight set reused at each application site).
    shared_attn_every: int = 0
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # --- capability flags ---
    encoder_only: bool = False       # no decode step
    subquadratic: bool = False       # can run long_500k
    # --- numerics / training ---
    param_dtype: str = "float32"     # master weights
    compute_dtype: str = "bfloat16"
    remat: bool = True               # checkpoint each layer in train fwd
    remat_group: int = 1             # layers per remat block (k-th-layer ckpt)
    scan_layers: bool = True         # lax.scan over stacked layer params
    # activation sharding hints; empty = no constraints (single-host path).
    act_batch_axes: Tuple[str, ...] = ()   # batch dim of activations
    act_model_axis: str = ""               # TP axis for attention heads
    seq_parallel: bool = False             # Megatron-SP: residual stream's
    # seq dim sharded over the TP axis between blocks (rs/ag pairs instead
    # of all-reduces; norms compute on 1/TP of the tokens)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.family in FAMILIES, self.family
        assert self.n_heads % self.n_kv_heads == 0, (self.n_heads, self.n_kv_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if shape.kind == "decode" and model.encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not model.subquadratic:
        return False, "long_500k requires sub-quadratic attention (full-attention arch)"
    return True, ""


# ---------------------------------------------------------------------------
# Run config (training hyperparameters, HeLoCo knobs)
# ---------------------------------------------------------------------------

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
    # pseudo-gradient compression, with error feedback (core/compression.py)
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
    mixture_alpha: Optional[float] = None    # Dirichlet language mixtures
    shard_assignment: str = "fixed"  # "fixed" | "flexible" (App. A.6)
    dylu: bool = False               # Dynamic Local Updates
    # The reference's later axes: the exchange topology (a PeerMixer off the
    # hub), the commit buffer and the hogwild batch ramp-up.
    topology: str = "hub"            # "hub" | "ring" | "gossip"
    commit_batch: int = 1            # arrivals coalesced per commit
    batch_rampup: Optional[int] = None       # per-round batch ramp target


def reduced(model: ModelConfig, *, seq_friendly: bool = False) -> ModelConfig:
    """Smoke-test variant: same family/block pattern, tiny dims."""
    n_layers = min(model.n_layers, 4)
    sa = model.shared_attn_every
    if sa:
        sa = 2
        n_layers = 4
    slstm_at = tuple(i for i in model.xlstm.slstm_at if i < n_layers)
    if model.xlstm.slstm_at and not slstm_at:
        slstm_at = (1,)
    kv = min(model.n_kv_heads, 2)
    heads = max(4, kv)
    moe = model.moe
    if model.is_moe:
        moe = replace(moe, n_experts=4, top_k=min(model.moe.top_k, 2),
                      expert_d_ff=64, group_size=64)
    fe = model.frontend
    if fe.kind == "vision":
        fe = replace(fe, n_prefix_tokens=4)
    return replace(
        model,
        name=model.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if model.d_ff else 0,
        vocab_size=128,
        moe=moe,
        ssm=replace(model.ssm, d_state=8, head_dim=8, chunk_size=16),
        xlstm=replace(model.xlstm, slstm_at=slstm_at, chunk_size=8),
        shared_attn_every=sa,
        frontend=fe,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
