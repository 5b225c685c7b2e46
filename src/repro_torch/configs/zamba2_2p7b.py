"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,                      # shared-attention block heads (MHA)
    n_kv_heads=32,
    d_ff=10240,                      # shared-block MLP
    vocab_size=32000,
    head_dim=80,
    norm="rmsnorm",
    mlp_act="gelu",
    block_kind="mamba2",
    shared_attn_every=6,             # one shared attn+MLP block every 6 mamba layers
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1,
                  conv_kernel=4, chunk_size=256),
    subquadratic=True,
    tied_embeddings=True,
)
