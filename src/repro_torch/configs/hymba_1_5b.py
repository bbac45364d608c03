"""Hymba-1.5B: parallel attention + mamba heads in each block.

[hybrid] 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001
ssm_state=16 [arXiv:2411.13676].
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    sliding_window=None,
    fed_axis="data", recurrent_chunk=256,
    source="arXiv:2411.13676",
)
