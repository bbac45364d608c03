"""Pixtral-12B backbone: pixtral-ViT + mistral-nemo decoder.

[vlm] 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409]. Vision encoder is a stub frontend:
input_specs() provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    rope_theta=1_000_000.0,
    frontend="vision", n_prefix_embeds=256,
    fed_axis="pod",
    source="hf:mistralai/Pixtral-12B-2409",
)
