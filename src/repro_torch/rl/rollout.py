"""Batched fixed-horizon rollouts with absorbing termination: the port of
the JAX package's ``rl/rollout.py``.

All K agents' M trajectories step together, one Python iteration per time
step where the reference has ``lax.scan``. Randomness comes in as tensors:
the reset states ``s0`` and the Gumbel noise of every action draw, so the
action is ``argmax(gumbel + logits·scale)``, which is what
``jax.random.categorical`` computes (both frameworks take the first
maximum).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Trajectory(NamedTuple):
    obs: torch.Tensor        # (K, M, H, obs_dim), recorded before the step
    actions: torch.Tensor    # (K, M, H) int64
    rewards: torch.Tensor    # (K, M, H), zero once done
    mask: torch.Tensor       # (K, M, H), 1.0 while the episode is alive


@torch.no_grad()
def rollout(env, policy, theta: torch.Tensor, s0: torch.Tensor,
            gumbel: torch.Tensor,
            logit_scale: Optional[torch.Tensor] = None) -> Trajectory:
    """theta (K, d), s0 (K, M, obs_dim), gumbel (K, M, H, A), logit_scale
    (K,) or None -> a (K, M, H) batch of trajectories.

    The state freezes once done and later rewards are masked; an agent
    with ``logit_scale`` 0 acts uniformly at random (``argmax(gumbel)``).
    """
    H = gumbel.shape[2]
    s = s0
    alive = torch.ones(s0.shape[:-1], dtype=s0.dtype, device=s0.device)
    obs, actions, rewards, masks = [], [], [], []
    for h in range(H):
        logits = policy(theta, s)
        if logit_scale is not None:
            logits = logits * logit_scale[:, None, None]
        a = torch.argmax(gumbel[:, :, h] + logits, dim=-1)
        s2, r, done = env.step(s, a)
        obs.append(s)
        actions.append(a)
        rewards.append(r * alive)
        masks.append(alive)
        s = torch.where(alive[..., None] != 0, s2, s)
        alive = alive * (1.0 - done.float())
    return Trajectory(torch.stack(obs, 2), torch.stack(actions, 2),
                      torch.stack(rewards, 2), torch.stack(masks, 2))


def sample_batch(env, policy, theta: torch.Tensor,
                 generator: torch.Generator, n: int,
                 logit_scale: Optional[torch.Tensor] = None) -> Trajectory:
    """A (K, n, H) batch: n trajectories of each of the K agents' policies
    θ (K, d), their reset states and then their action noise drawn from
    ``generator`` (in the steps' order, ``core/noise.py``): the
    reference's ``sample_batch`` in the port's form (a generator and a
    flat θ stack where it vmaps one parameter tree over keys)."""
    from repro_torch.core.noise import _gumbel
    K = theta.shape[0]
    s0 = env.reset(generator, (K, n))
    gumbel = _gumbel(generator, (K, n, env.horizon, env.n_actions))
    return rollout(env, policy, theta, s0, gumbel, logit_scale)


def batch_return(traj: Trajectory, gamma: float = 1.0) -> torch.Tensor:
    """(K, M) discounted returns."""
    H = traj.rewards.shape[-1]
    disc = gamma ** torch.arange(H, dtype=traj.rewards.dtype,
                                 device=traj.rewards.device)
    return (traj.rewards * disc).sum(-1)
