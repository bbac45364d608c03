"""MusicGen-medium decoder backbone over EnCodec tokens.

[audio] 48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048
[arXiv:2306.05284]. The mel/EnCodec conv frontend is a stub:
input_specs() provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    frontend="audio", n_prefix_embeds=128,
    fed_axis="data",
    source="arXiv:2306.05284",
)
