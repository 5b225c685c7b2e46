"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    head_dim=128,
    rope_theta=10_000.0,
    norm="rmsnorm",
    mlp_act="swiglu",
    tied_embeddings=True,
)
