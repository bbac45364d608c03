"""MiniCPM3-4B with multi-head latent attention (MLA).

[dense] 62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448
[hf:openbmb/MiniCPM3-4B]. MLA dims follow the model card:
q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448, head_dim=96,
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    fed_axis="pod", mla_absorb=True,
    source="hf:openbmb/MiniCPM3-4B",
)
