"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    rope_theta=10_000.0,
    norm="rmsnorm",
    mlp_act="swiglu",
    block_kind="moe",
    tied_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, expert_d_ff=512),
)
