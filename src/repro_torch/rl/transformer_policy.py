"""Transformer policies: a ``models`` architecture as the categorical
policy network, served and trained.

The port of the JAX package's ``rl/transformer_policy.py``, registered
under the ``policy`` namespace as ``"transformer"``. The observation
enters the model as one projected prefix embedding (the config's
modality-frontend slot): obs is written into the leading ``obs_dim``
coordinates of a (B, 1, d_model) prefix, a BOS token anchors the text
side, and the action logits are the first ``n_actions`` entries of the
last position's LM head output.

The port serves these policies (``repro_torch.serving``) and trains
them with DecByzPG and ByzPG: the model's parameters ravel into one flat
θ row per agent, in the reference's ``ravel_pytree`` order
(:func:`repro_torch.core.tree.ravel_tree`), which the robust aggregators
and the agreement rounds take like the MLP's.

Every pass the algorithms make (rollouts, gradient estimates,
importance weights) goes through :meth:`TransformerPolicy.forward` on the
``"chunked"`` attention route, the reference's differentiable one, so
actions are sampled under the same float results that are then
differentiated. Serving's :meth:`TransformerPolicy.logits` keeps the flash
kernel (forward only) by default.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.core import tree
from repro_torch.core.registry import register
from repro_torch.models.model import forward, init_params, param_shapes


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


class TransformerPolicy(nn.Module):
    """A servable and trainable policy.

    Serving reads ``model_cfg``, ``n_actions``, ``obs_dim``,
    ``init(generator)`` (a parameter dict) and ``logits(params, obs)``.
    The algorithms read the protocol of
    :class:`~repro_torch.rl.policy.MLPPolicy`: ``d``,
    ``init_theta(generator)`` (a flat (d,) θ₀), ``layers(theta)`` and
    ``forward(theta (K, d), obs (K, ..., obs_dim)) -> (K, ...,
    n_actions)``. ``remat`` checkpoints each layer while autograd records
    (the reference's keyword; off by default, since the policy's
    sequences have two positions)."""

    def __init__(self, cfg: ModelConfig, obs_dim: int, n_actions: int,
                 remat: bool = False):
        super().__init__()
        self.model_cfg = cfg
        self.obs_dim = int(obs_dim)
        self.n_actions = int(n_actions)
        self.remat = bool(remat)
        self.shapes = param_shapes(cfg)
        self.d = tree.tree_size(self.shapes)

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on the generator's device."""
        return init_params(self.model_cfg, generator,
                           device=generator.device)

    def init_theta(self, generator: torch.Generator) -> torch.Tensor:
        """One agent's flat θ (d,) from :meth:`init`."""
        return tree.ravel_tree(self.init(generator))

    def layers(self, theta: torch.Tensor) -> dict:
        """θ (d,) -> the parameter dict, as views of θ."""
        return tree.unravel_tree(theta, self.shapes)

    def logits(self, params: dict, obs: torch.Tensor,
               attention: str = "flash") -> torch.Tensor:
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
                               prefix_embeds=prefix, last_only=True,
                               remat=self.remat, attention=attention)
        return logits[:, -1, :self.n_actions].reshape(*lead, self.n_actions)

    def forward(self, theta: torch.Tensor, obs: torch.Tensor
                ) -> torch.Tensor:
        """The K agents one after another, each on a view of its row of
        θ, on the chunked route (module docstring)."""
        return torch.stack([self.logits(self.layers(theta[k]), obs[k],
                                        "chunked")
                            for k in range(theta.shape[0])])


@register("policy", "transformer")
def _transformer_policy_factory(env, arch: str = "qwen2.5-3b",
                                n_layers=None, d_model=None, n_heads=None,
                                d_ff=None, remat: bool = False):
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
    return TransformerPolicy(cfg, env.obs_dim, env.n_actions, remat)
