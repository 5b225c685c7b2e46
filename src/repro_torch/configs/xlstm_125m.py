"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1]-style placement)
[arXiv:2405.04517; unverified]."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                          # xLSTM blocks integrate their projections
    vocab_size=50304,
    head_dim=192,
    norm="layernorm",
    block_kind="mlstm",
    xlstm=XLSTMConfig(slstm_at=(3, 9)),
    subquadratic=True,
    scan_layers=False,               # 12 mixed blocks: unrolled
    tied_embeddings=True,
)
