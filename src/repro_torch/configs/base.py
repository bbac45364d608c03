"""Config system: architecture configs, input shapes, registry.

The port's own copy of the JAX package's ``configs/base.py`` (data only,
no framework): one ``repro_torch/configs/<id>.py`` per architecture
defines ``CONFIG``; ``get_config(name)`` resolves by registry id or alias;
``reduced(cfg)`` derives the CPU smoke-test variant (2 layers,
d_model<=512, <=4 experts) from the same family. The values equal the
reference's, so a config means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""
    kv_lora_rank: int
    q_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (used by hybrid blocks)."""
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM: alternating mLSTM / sLSTM blocks."""
    slstm_every: int = 2            # every n-th block is sLSTM, rest mLSTM
    proj_factor: float = 2.0        # mLSTM up-projection factor
    conv_dim: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # sub-configs (None if unused by the family)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # long-context serving: sliding-window variant used by long_500k decode
    long_context_window: int = 4096
    # attention sliding window in *all* modes (None = full causal)
    sliding_window: Optional[int] = None
    # modality frontend stub: none | vision | audio
    frontend: str = "none"
    n_prefix_embeds: int = 0        # prepended patch/frame embeddings
    # federation mapping (see DESIGN.md §3)
    fed_axis: str = "data"          # data | pod
    # shard the layer-stack dim over "data" (FSDP-over-layers; see
    # distributed/sharding.py) — for pod-federated archs too big otherwise
    fsdp_layers: bool = False
    # MLA decode: weight-absorbed latent attention (§Perf optimization;
    # False = naive expand-K/V-from-latent baseline)
    mla_absorb: bool = False
    # RMSNorm without materializing an f32 copy of the activations
    # (§Perf optimization; reduction still in f32)
    fused_rmsnorm: bool = False
    # recurrent scans: remat in time-chunks of this size (0 = plain scan
    # saving carry every step — §Perf baseline)
    recurrent_chunk: int = 0
    # small-model federation: replicate params per agent and use the model
    # axis for intra-agent batch parallelism instead of tensor parallelism
    # (one grad all-reduce per step instead of 2 per layer; §Perf)
    intra_agent_dp: bool = False
    source: str = ""                # citation from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_recurrent(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (matches init_params up to ties)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        per_layer = 0
        if self.family == "ssm":  # xLSTM
            x = self.xlstm
            d_in = int(d * x.proj_factor)
            m = d * d_in * 2 + 3 * d_in * (d_in // max(1, self.n_heads)) \
                + d_in * d_in + d_in * d + 2 * d
            s = 4 * d * d + 4 * d * d + d * d + 2 * d
            n_s = self.n_layers // x.slstm_every
            n_m = self.n_layers - n_s
            return emb + head + n_m * m + n_s * s + d
        # attention params
        if self.mla is not None:
            a = self.mla
            qk_hd = a.qk_nope_head_dim + a.qk_rope_head_dim
            attn = (d * a.q_lora_rank + a.q_lora_rank * self.n_heads * qk_hd
                    + d * (a.kv_lora_rank + a.qk_rope_head_dim)
                    + a.kv_lora_rank * self.n_heads
                    * (a.qk_nope_head_dim + a.v_head_dim)
                    + self.n_heads * a.v_head_dim * d)
        else:
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
        # mlp params
        if self.moe is not None:
            m = self.moe
            mlp = m.n_experts * 3 * d * m.d_ff_expert \
                + m.n_shared_experts * 3 * d * m.d_ff_expert \
                + d * m.n_experts
        else:
            mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            dtr = s.dt_rank or -(-d // 16)
            per_layer += (d * 2 * d_in + s.conv_dim * d_in
                          + d_in * (dtr + 2 * s.state_dim) + dtr * d_in
                          + d_in * s.state_dim + d_in + d_in * d)
        return emb + head + self.n_layers * per_layer + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return self.n_params() - self.n_layers * inactive


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "pixtral_12b",
    "llama3_2_1b",
    "hymba_1_5b",
    "xlstm_350m",
    "minicpm3_4b",
    "musicgen_medium",
    "grok_1_314b",
    "qwen2_7b",
    "qwen2_5_3b",
    "deepseek_v2_lite_16b",
)

_ALIASES = {
    "pixtral-12b": "pixtral_12b",
    "llama3.2-1b": "llama3_2_1b",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-350m": "xlstm_350m",
    "minicpm3-4b": "minicpm3_4b",
    "musicgen-medium": "musicgen_medium",
    "grok-1-314b": "grok_1_314b",
    "qwen2-7b": "qwen2_7b",
    "qwen2.5-3b": "qwen2_5_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}


def get_config(name: str) -> ModelConfig:
    key = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def all_configs() -> Tuple[ModelConfig, ...]:
    return tuple(get_config(a) for a in ARCH_IDS)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests.

    2 layers, d_model<=512, <=4 experts, small vocab.
    """
    d = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    kw = dict(
        n_layers=2, d_model=d, n_heads=n_heads, n_kv_heads=n_kv,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=d // n_heads,
        long_context_window=64,
        n_prefix_embeds=min(cfg.n_prefix_embeds, 8),
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            d_ff_expert=min(cfg.moe.d_ff_expert, 128))
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                              qk_nope_head_dim=16, qk_rope_head_dim=16,
                              v_head_dim=16)
        kw["head_dim"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8)
    if cfg.xlstm is not None:
        kw["xlstm"] = cfg.xlstm
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **kw)
