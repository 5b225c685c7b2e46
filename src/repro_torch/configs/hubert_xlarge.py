"""hubert-xlarge [audio] — encoder-only (w2v2-style backbone); conv feature
frontend is a STUB (input_specs provides precomputed frame embeddings)
[arXiv:2106.07447; unverified]."""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,                 # masked-unit prediction targets
    head_dim=80,
    norm="layernorm",
    mlp_act="gelu",
    causal=False,
    encoder_only=True,
    frontend=FrontendConfig(kind="audio"),
)
