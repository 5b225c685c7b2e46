"""tinygpt-15m: the paper's own evaluation model (TinyGPT, GPT-2 tokenizer,
~15M parameters)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinygpt-15m",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=1024,
    vocab_size=50257,
    head_dim=32,
    norm="layernorm",
    mlp_act="gelu",
    tied_embeddings=True,
    remat=False,
    scan_layers=False,
)
