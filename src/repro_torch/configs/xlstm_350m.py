"""xLSTM-350M: alternating sLSTM + mLSTM blocks (no FFN, d_ff=0).

[ssm] 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517].
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
    xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, conv_dim=4),
    fed_axis="data", recurrent_chunk=256,
    source="arXiv:2405.04517",
)
