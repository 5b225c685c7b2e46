"""llama4-scout-17b-a16e [moe] — MoE 16e top-1 + shared expert, early fusion
(multimodal frontend stubbed; text backbone per assignment)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    rope_theta=500_000.0,
    norm="rmsnorm",
    mlp_act="swiglu",
    block_kind="moe",
    moe=MoEConfig(n_experts=16, top_k=1, expert_d_ff=8192, shared_expert=True),
)
