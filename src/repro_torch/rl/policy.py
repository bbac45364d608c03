"""MLP categorical policy over a flat per-agent parameter stack.

The port of the JAX package's ``rl/policy.py`` (paper Table 1: 16,16 ReLU
for CartPole, 64,64 Tanh for LunarLander). Each agent's weights are one row
of θ (K, d), in the reference's ``ravel_pytree`` order
(:mod:`repro_torch.core.tree`). :class:`MLPPolicy` holds no parameters of
its own: its forward pass reads the K agents' layers as views of θ and
computes all their logits in one batched pass.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from repro_torch.core import tree
from repro_torch.core.registry import register, resolve


class MLPPolicy(nn.Module):
    """Logits of K agents' MLPs from θ (K, d): ``forward(theta, obs)``
    with obs (K, ..., obs_dim) -> logits (K, ..., n_actions)."""

    def __init__(self, sizes: Sequence[int], activation: str = "tanh"):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be 'tanh' or 'relu', got "
                             f"{activation!r}")
        self.sizes = tuple(sizes)
        self.activation = activation
        self.shapes = [{"w": (din, dout), "b": (dout,)}
                       for din, dout in zip(self.sizes[:-1], self.sizes[1:])]
        self.d = tree.size(self.shapes)

    def layers(self, theta: torch.Tensor) -> List[dict]:
        """θ (..., d) -> per-layer views ``{"w": (..., din, dout),
        "b": (..., dout)}``."""
        return tree.unravel(theta, self.shapes)

    def forward(self, theta: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        K = theta.shape[0]
        lead = obs.shape[1:-1]
        x = obs.reshape(K, -1, obs.shape[-1])
        act = torch.tanh if self.activation == "tanh" else torch.relu
        layers = self.layers(theta)
        for i, layer in enumerate(layers):
            x = torch.bmm(x, layer["w"]) + layer["b"][:, None, :]
            if i < len(layers) - 1:
                x = act(x)
        return x.reshape(K, *lead, x.shape[-1])

    def init(self, generator: torch.Generator) -> torch.Tensor:
        """One agent's flat θ (d,) from :func:`init_mlp`."""
        return tree.ravel(init_mlp(generator, self.sizes))


def init_mlp(generator: torch.Generator, sizes: Sequence[int]) -> List[dict]:
    """``[{"w": (din, dout), "b": (dout,)}, ...]`` on the generator's
    device: normal weights scaled by din^-1/2, zero biases, as the
    reference's ``init_mlp``."""
    dev = generator.device
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=generator, device=dev) \
            * (din ** -0.5)
        params.append({"w": w, "b": torch.zeros(dout, device=dev)})
    return params


def mlp_sizes(env, hidden) -> tuple:
    """Layer sizes of the policy for ``env`` with the given hidden spec."""
    return (env.obs_dim, *hidden, env.n_actions)


@register("policy", "mlp")
def _mlp_policy_factory(env, hidden=None, activation=None,
                        cfg_hidden=(16, 16), cfg_activation="tanh"):
    """``cfg_hidden``/``cfg_activation`` carry the algorithm config's
    fields; explicit spec kwargs (``mlp(hidden=(32,32))``) win."""
    h = tuple(cfg_hidden if hidden is None else hidden)
    act = cfg_activation if activation is None else activation
    return MLPPolicy(mlp_sizes(env, h), act)


def resolve_policy(cfg, env) -> MLPPolicy:
    """Resolve a config's ``policy`` spec, feeding ``cfg.hidden`` and
    ``cfg.activation`` as the MLP defaults. DecByzPG trains MLP policies
    only: the transformer policy is served (``repro_torch.serving``), and
    training through it waits for a backward of the flash-attention op
    (ROADMAP Queue 1)."""
    policy = resolve("policy", cfg.policy, env=env,
                     cfg_hidden=tuple(cfg.hidden),
                     cfg_activation=cfg.activation)
    if not isinstance(policy, MLPPolicy):
        raise NotImplementedError(
            f"DecByzPG with policy {cfg.policy} is not ported yet: training "
            f"a transformer policy needs a backward for flash attention "
            f"(ROADMAP Queue 1)")
    return policy
