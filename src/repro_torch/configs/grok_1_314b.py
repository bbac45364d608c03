"""Grok-1 (314B): 8-expert top-2 MoE.

[moe] 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072
MoE 8e top-2 [hf:xai-org/grok-1].
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=0,
                  d_ff_expert=32768),
    fed_axis="pod", fsdp_layers=True,
    source="hf:xai-org/grok-1",
)
