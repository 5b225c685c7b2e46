"""starcoder2-15b [dense] — GQA, RoPE, GeLU MLP, LayerNorm, biases
[arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    qkv_bias=True,
    mlp_bias=True,
    rope_theta=100_000.0,
    norm="layernorm",
    mlp_act="gelu",
)
