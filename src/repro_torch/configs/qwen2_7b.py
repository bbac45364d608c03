"""Qwen2-7B. [dense] 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    rope_theta=1_000_000.0, qkv_bias=True,
    fed_axis="pod",
    source="arXiv:2407.10671",
)
