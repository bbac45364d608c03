"""Transformer policies: a ``models`` architecture as the categorical
policy network, forward only.

The port of the JAX package's ``rl/transformer_policy.py``, registered
under the ``policy`` namespace as ``"transformer"``. The observation
enters the model as one projected prefix embedding (the config's
modality-frontend slot): obs is written into the leading ``obs_dim``
coordinates of a (B, 1, d_model) prefix, a BOS token anchors the text
side, and the action logits are the first ``n_actions`` entries of the
last position's LM head output.

The port serves these policies (``repro_torch.serving``); training
DecByzPG through one needs a backward for the flash-attention op and
waits for the next slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.core.registry import register
from repro_torch.models.model import forward, init_params


def transformer_policy_config(arch: str = "qwen2.5-3b", n_layers=None,
                              d_model=None, n_heads=None, d_ff=None
                              ) -> ModelConfig:
    """Policy-sized model config: ``reduced(arch)`` with the modality
    frontend enabled (one prefix embedding carries the observation).
    Optional overrides shrink it further."""
    cfg = reduced(get_config(arch))
    kw = {"frontend": "state", "n_prefix_embeds": 1}
    if n_layers is not None:
        kw["n_layers"] = int(n_layers)
    if n_heads is not None:
        kw["n_heads"] = int(n_heads)
        kw["n_kv_heads"] = min(cfg.n_kv_heads, int(n_heads))
    if d_model is not None:
        kw["d_model"] = int(d_model)
    if d_ff is not None:
        kw["d_ff"] = int(d_ff)
    if (d_model is not None or n_heads is not None) and cfg.mla is None:
        d = kw.get("d_model", cfg.d_model)
        h = kw.get("n_heads", cfg.n_heads)
        if d % h:
            raise ValueError(f"d_model={d} not divisible by n_heads={h}")
        kw["head_dim"] = d // h
    return dataclasses.replace(cfg, **kw)


class TransformerPolicy:
    """A servable policy: ``model_cfg``, ``n_actions``, ``obs_dim``,
    ``init(generator)`` and ``logits(params, obs)``."""

    def __init__(self, cfg: ModelConfig, obs_dim: int, n_actions: int):
        self.model_cfg = cfg
        self.obs_dim = int(obs_dim)
        self.n_actions = int(n_actions)

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on the generator's device."""
        return init_params(self.model_cfg, generator,
                           device=generator.device)

    def logits(self, params: dict, obs: torch.Tensor) -> torch.Tensor:
        """obs (..., obs_dim) -> logits (..., n_actions); leading dims are
        flattened into the forward batch and restored."""
        cfg = self.model_cfg
        lead = obs.shape[:-1]
        ob = obs.reshape(-1, self.obs_dim)
        B = ob.shape[0]
        prefix = torch.zeros((B, 1, cfg.d_model), dtype=ob.dtype,
                             device=ob.device)
        prefix[:, 0, :self.obs_dim] = ob
        bos = torch.zeros((B, 1), dtype=torch.long, device=ob.device)
        logits, _, _ = forward(cfg, params, tokens=bos,
                               prefix_embeds=prefix, last_only=True)
        return logits[:, -1, :self.n_actions].reshape(*lead, self.n_actions)


@register("policy", "transformer")
def _transformer_policy_factory(env, arch: str = "qwen2.5-3b",
                                n_layers=None, d_model=None, n_heads=None,
                                d_ff=None):
    """``policy="transformer(arch='qwen2.5-3b', n_layers=1, ...)"``."""
    cfg = transformer_policy_config(arch, n_layers=n_layers,
                                    d_model=d_model, n_heads=n_heads,
                                    d_ff=d_ff)
    if cfg.d_model < env.obs_dim:
        raise ValueError(f"transformer policy d_model={cfg.d_model} < "
                         f"obs_dim={env.obs_dim} for env {env.name!r}")
    if cfg.vocab_size < env.n_actions:
        raise ValueError(f"transformer policy vocab_size={cfg.vocab_size} "
                         f"< n_actions={env.n_actions}")
    return TransformerPolicy(cfg, env.obs_dim, env.n_actions)
