"""Policy-gradient estimators over K agents at once: the port of the JAX
package's ``rl/gradient.py``.

REINFORCE and GPOMDP (paper App. A.1) as surrogates whose gradient is the
estimate, and the importance-weighted estimator used by the PAGE
correction, with clipped weights that carry no gradient. Trajectories are
(K, M, H, ...) and θ is (K, d); agent k's surrogate depends on row k alone,
so one backward pass over the sum across agents gives all K gradients.
``gamma`` and ``baseline`` are numbers, or (K,) tensors with one value per
agent: the rows of a lane group fold into the agent axis, each row's
agents taking the row's value.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.registry import register, resolve
from repro_torch.rl.rollout import Trajectory


def step_log_probs(policy, theta: torch.Tensor,
                   traj: Trajectory) -> torch.Tensor:
    """(K, M, H) log π_θ(a_h | s_h), masked."""
    lp = torch.log_softmax(policy(theta, traj.obs), dim=-1)
    lp = torch.gather(lp, -1, traj.actions[..., None])[..., 0]
    return lp * traj.mask


def per_agent(value, ndim: int):
    """A number as it is, or a (K,) tensor shaped (K, 1, ...) to broadcast
    over ``ndim`` dimensions led by the agents'."""
    if isinstance(value, torch.Tensor):
        return value.reshape(-1, *(1,) * (ndim - 1))
    return value


def _discounts(traj: Trajectory, gamma) -> torch.Tensor:
    H = traj.rewards.shape[-1]
    return per_agent(gamma, 3) ** torch.arange(
        H, dtype=traj.rewards.dtype, device=traj.rewards.device)


def _gpomdp_surrogate(lp, traj, gamma, baseline):
    """Σ_h (Σ_{t<=h} log π_t) (γ^h r_h − b_h): gradient = GPOMDP."""
    disc_r = traj.rewards * _discounts(traj, gamma) \
        - per_agent(baseline, 3) * traj.mask
    return (torch.cumsum(lp, -1) * disc_r.detach()).sum(-1)


def _reinforce_surrogate(lp, traj, gamma, baseline):
    g_return = (traj.rewards * _discounts(traj, gamma)).sum(-1)
    return lp.sum(-1) * (g_return - per_agent(baseline, 2)).detach()


register("estimator", "gpomdp")(lambda: _gpomdp_surrogate)
register("estimator", "reinforce")(lambda: _reinforce_surrogate)


def _weighted_mean(s: torch.Tensor, sample_weights) -> torch.Tensor:
    if sample_weights is None:
        return s.mean(-1)
    return (sample_weights * s).sum(-1)


def grad_estimate(policy, theta: torch.Tensor, traj: Trajectory,
                  gamma, baseline=0.0,
                  estimator="gpomdp",
                  sample_weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """(K, d): each agent's mean PG over its M trajectories.

    ``sample_weights`` (M,), summing to 1, replaces the uniform 1/M mean.
    """
    sur = resolve("estimator", estimator)
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        s = sur(step_log_probs(policy, th, traj), traj, gamma, baseline)
        (g,) = torch.autograd.grad(_weighted_mean(s, sample_weights).sum(),
                                   th)
    return g


@torch.no_grad()
def importance_weights(policy, theta_old: torch.Tensor,
                       theta_new: torch.Tensor, traj: Trajectory,
                       clip: float = 10.0) -> torch.Tensor:
    """(K, M) ω(τ | θ_new, θ_old) = p(τ|θ_old)/p(τ|θ_new), τ ~ p(·|θ_new),
    clipped to [1/clip, clip]."""
    lp_old = step_log_probs(policy, theta_old, traj).sum(-1)
    lp_new = step_log_probs(policy, theta_new, traj).sum(-1)
    c = math.log(clip)
    return torch.exp(torch.clamp(lp_old - lp_new, -c, c))


def weighted_grad_estimate(policy, theta_old: torch.Tensor,
                           theta_new: torch.Tensor, traj: Trajectory,
                           gamma, baseline=0.0,
                           estimator="gpomdp",
                           sample_weights: Optional[torch.Tensor] = None,
                           self_normalized: bool = False) -> torch.Tensor:
    """(K, d) IS-corrected PG at θ_old from trajectories sampled at θ_new.

    ``self_normalized`` divides by the realized weight mass instead of M
    (biased O(1/M), lower variance); the normalizer carries no gradient.
    """
    w = importance_weights(policy, theta_old, theta_new, traj)
    if self_normalized:
        mass = (sample_weights * w).sum(-1, keepdim=True) \
            if sample_weights is not None else w.mean(-1, keepdim=True)
        w = w / torch.clamp_min(mass, 1e-12)
    sur = resolve("estimator", estimator)
    with torch.enable_grad():
        th = theta_old.detach().requires_grad_(True)
        s = sur(step_log_probs(policy, th, traj), traj, gamma, baseline)
        loss = (w * s).mean(-1) if sample_weights is None \
            else (sample_weights * w * s).sum(-1)
        (g,) = torch.autograd.grad(loss.sum(), th)
    return g
