"""DeepSeek-V2-Lite (16B): MLA (kv_lora=512) + MoE 64e top-6, 2 shared.

[moe] 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400
[arXiv:2405.04434]. See DESIGN.md for the '64e vs 160 routed' note.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=192,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2,
                  d_ff_expert=1408),
    fed_axis="pod", mla_absorb=True,
    source="arXiv:2405.04434",
)
