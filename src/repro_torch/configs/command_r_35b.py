"""command-r-35b [dense] — GQA, no-bias, parallel attn+FFN blocks, LayerNorm
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    rope_theta=8_000_000.0,
    norm="layernorm",
    mlp_act="swiglu",
    parallel_block=True,
    tied_embeddings=True,
)
