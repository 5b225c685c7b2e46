"""paligemma-3b [vlm] — SigLIP (stub) + gemma decoder, MQA
[arXiv:2407.07726; hf]."""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    rope_theta=10_000.0,
    norm="rmsnorm",
    mlp_act="geglu",
    tied_embeddings=True,
    embed_scale=True,
    frontend=FrontendConfig(kind="vision", n_prefix_tokens=256),
)
